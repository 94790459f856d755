"""launch_wall_ms: the mean wall time of the engine's count_programs calls
(lowered programs to counts: batch packing, uploads, the launch and the
read-back), from the benchmark's span around the method."""


def read(run):
    if run.trace is None:
        return None
    times = [(end - start) / 1e6
             for start, end in run.trace.window_spans("count_programs")]
    return sum(times) / len(times) if times else None
