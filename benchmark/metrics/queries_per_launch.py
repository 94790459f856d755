"""queries_per_launch: the queries answered in the window over the VM
launches the port's counters show."""


def read(run):
    launches = run.counter("vm_launches")
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    return answered / launches if launches else None
