"""queries_per_launch.hot: queries_per_launch in the cells whose end-to-end
metric is the card's time per query: more queries a launch share its
fixed cost."""


def read(run):
    launches = run.counter("vm_launches")
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    return answered / launches if launches else None
