"""card_us_per_query: the card's busy time in the window (the union of its
kernels, copies and fills on the profiler's timeline) over the queries
answered inside the window: what a query costs the card, whatever the host
does meanwhile."""

from benchmark.tracing import busy_s


def read(run):
    trace = run.trace
    answered = sum(1 for r in run.records if r.ok and r.end <= run.t1)
    if trace is None or not trace.device_events or not answered:
        return None
    return 1e6 * busy_s(trace.device_events, trace.t0_ns,
                        trace.t1_ns) / answered
