"""vm_roofline_pct: the least time of the window's count launches at the
card's published bandwidth (benchmark/roofline.py: bytes from the queries
each launch answered and the corpus' shape) over the VM kernels' time on
the card, in the counts cell."""

from benchmark.roofline import vm_roofline_pct


def read(run):
    return vm_roofline_pct(run)
