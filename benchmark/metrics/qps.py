"""qps: the queries answered in the window over the window's length."""


def read(run):
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    return answered / (run.t1 - run.t0)
