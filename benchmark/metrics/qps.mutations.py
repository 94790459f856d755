"""qps.mutations: the Mutations queries answered in the window over the
window's length, in the lineage cell, read per layer as qps.counts is (the
host's rate, which the Mutations assembly on the host sets)."""


def read(run):
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    return answered / (run.t1 - run.t0)
