"""vm_roofline_pct.hot: vm_roofline_pct in the cells whose end-to-end
metric is the card's time per query: the VM kernels' share of their
roofline sets most of that time."""

from benchmark.roofline import vm_roofline_pct


def read(run):
    return vm_roofline_pct(run)
