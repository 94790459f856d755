"""qps.counts: the queries answered in the window over the window's length,
in the counts cell, where it is a per-layer reading (the host's rate under
the micro-batcher's dispatcher): its runs spread too widely for a bound."""


def read(run):
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    return answered / (run.t1 - run.t0)
