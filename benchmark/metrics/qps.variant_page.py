"""qps.variant_page: the requests of the variant pages answered in the
window over the window's length, read per layer as qps.mutations is (the
host's rate, which the per-partition lowering and the host assembly
set)."""


def read(run):
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    return answered / (run.t1 - run.t0)
