"""device_idle_pct.variant_page: the share of the traced window in which
no kernel, copy or fill runs on the card, in the variant-page cell."""

from benchmark.tracing import busy_s


def read(run):
    trace = run.trace
    if trace is None or not trace.device_events:
        return None
    return 100.0 * (1 - busy_s(trace.device_events, trace.t0_ns, trace.t1_ns)
                    / trace.window_s)
