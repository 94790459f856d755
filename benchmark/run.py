#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one NVIDIA GPU.

    python3 benchmark/run.py --workload dense1m.counts --seed 7 --seconds 10 --trace 0

Set-up draws the corpus from the seed, builds the port's database and
installs its device engine on ``cuda:0`` (``lapis_silo_torch.install``),
then warms the cell's routes with requests of its own mix. The corpus, the
requests and the plain reference come from the module that the cell's
configuration names under ``"corpus"`` (``CORPUS_CONTRACT``). The window
drives ``Database.execute_query`` from client threads for ``--seconds``.
Once it has closed, the plain reference checks a sample of the answers
drawn from the seed. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit; the checks also end standard error. Stages of the set-up
and other readings go to standard error on earlier lines. The card's
timeline (``torch.profiler``, device activity only) is recorded in a traced
run, and in an untraced one where one of the cell's end-to-end metrics is
read from it (``"source": "device_trace"``).

The run exits non-zero and prints no result without as many CUDA devices as
the cell asks for, and when ``jax``, ``jaxlib``, ``flax`` or
``lapis_silo_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "lapis_silo_tpu")
# what the harness calls on a configuration's corpus module, and nothing else
CORPUS_CONTRACT = ("draw_for", "build_database", "generator_for",
                   "reference_for", "stale_reference_for")
METRICS_DIR = Path(__file__).resolve().parent / "metrics"


def _process_start() -> float:
    """The process' start on the perf_counter clock (from /proc; the
    module's import where that cannot be read)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.perf_counter() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


PROCESS_START = _process_start()


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# -- the benchmark's files ------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def by_name(entries: list[dict], name: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"BENCHMARK.json has no entry {name!r}")


def cell_files(spec: dict, workload: str, overrides: dict | None = None):
    """The cell's configuration and traffic mix, read by their names;
    `overrides` ({"config": {...}, "mix": {...}}) shrink them for the tests
    on the CPU."""
    from benchmark.traffic.generator import load_mix
    cell = by_name(spec["workloads"], workload)
    config = json.loads((ROOT / by_name(spec["configs"], cell["config"])
                         ["file"]).read_text())
    mix = load_mix(cell["traffic"])
    config.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("mix", {}))
    return config, mix


def corpus_module(config: dict):
    """The module named by the configuration's ``"corpus"``: a module under
    ``benchmark.`` that gives every function of ``CORPUS_CONTRACT``."""
    name = config.get("corpus")
    if not isinstance(name, str) or not name.startswith("benchmark."):
        raise SystemExit(f"configuration {config.get('name')!r}: \"corpus\" "
                         f"must name a module under benchmark., not {name!r}")
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as error:
        raise SystemExit(f"configuration {config.get('name')!r}: corpus "
                         f"module {name!r} cannot be imported: {error}")
    missing = [f for f in CORPUS_CONTRACT
               if not callable(getattr(module, f, None))]
    if missing:
        raise SystemExit(f"configuration {config.get('name')!r}: corpus "
                         f"module {name} lacks {', '.join(missing)}")
    return module


def metric_entries(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones:
    those that list the cell, and those that list none whose end-to-end
    metric the cell reports."""
    def listed(entry):
        return cell in entry.get("workloads", [cell])
    end_to_end = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return end_to_end
    reported = {m["name"] for m in end_to_end}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def records_timeline(spec: dict, cell: str, trace: bool) -> bool:
    """Whether a run records the card's timeline: every traced run, and an
    untraced one where one of the cell's end-to-end metrics reads it."""
    return trace or any(m["source"] == "device_trace"
                        for m in metric_entries(spec, cell, False))


def metric_module(name: str):
    """``metrics/<name>.py``: its ``read(run)``, and where the metric reads
    program counters, its ``counters(engine)``."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", METRICS_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """``metrics/<name>.py``'s ``read(run)``."""
    return metric_module(name).read


def counter_probes(spec: dict, cell: str, trace: bool) -> list:
    """The ``counters(engine)`` of the run's metric readers that have one:
    each returns {name: int} of the program's counters that its metric
    reads, snapshotted at the window's open and close beside `counters`."""
    modules = (metric_module(m["name"])
               for m in metric_entries(spec, cell, trace))
    return [m.counters for m in modules if callable(getattr(m, "counters",
                                                            None))]


# -- one run --------------------------------------------------------------------

@dataclass
class Run:
    """What the metric readers read."""
    records: list
    t0: float  # the window, perf_counter seconds
    t1: float
    grace_s: float
    setup_s: float
    flat_words: int
    counters: dict = field(default_factory=dict)  # name: (open, close)
    trace: object = None
    lateness: list = field(default_factory=list)

    def counter(self, name: str) -> int:
        opened, closed = self.counters[name]
        return closed - opened


def counters(engine, probes=()) -> dict:
    """The program's counters that every run logs, and those that the
    `probes` (`counter_probes`) add."""
    from lapis_silo_torch.ops import kernels
    vm = (kernels.VM_RUN, kernels.VM_RUN_SHARDED)
    out = {"vm_launches": sum(k.launches + k.plain_launches for k in vm),
           "pool_hits": engine.pool_hits, "pool_misses": engine.pool_misses}
    for probe in probes:
        out.update(probe(engine))
    return out


def holder(seed: int, n_ahead: int, quota: int):
    """Which of a closed loop's answers are kept for the check: about one
    in n_ahead / (16 quota) of the requests, picked by a hash of the seed
    and the request's index, so that a window that answers a sixteenth of
    what was drawn ahead still holds the check's quota."""
    every = max(1, n_ahead // (16 * quota))
    return lambda i: hash((seed, i)) % every == 0


def sample(records, quotas: dict, seed: int) -> list:
    """Up to each kind's quota of the answered requests whose answers were
    kept, drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng([seed, 4])
    out = []
    for kind, quota in quotas.items():
        pool = [r for r in records if r.kind == kind and r.ok and r.held]
        for i in sorted(rng.permutation(len(pool))[:quota].tolist()):
            out.append(pool[i])
    return out


class Cell:
    """A cell set up on `device`: its corpus drawn from the seed, the port's
    database with its device engine installed, and the traffic generator.
    `overrides` ({"config": {...}, "mix": {...}}) shrink a cell for the
    tests on the CPU."""

    def __init__(self, workload: str, seed: int, device,
                 overrides: dict | None = None, spec: dict | None = None):
        import torch

        self.torch = torch
        self.spec = spec or load_spec()
        self.workload, self.seed, self.device = workload, seed, device
        config, self.mix = cell_files(self.spec, workload, overrides)
        self.corpus_module = corpus_mod = corpus_module(config)
        at = PROCESS_START

        import lapis_silo_torch
        from lapis_silo_torch.ops import kernels
        at = self._stage("start_and_imports", at)
        if device.type == "cuda":
            kernels.load_library()
            at = self._stage("kernels", at)
        self.corpus = corpus_mod.draw_for(config, seed)
        at = self._stage("corpus_draw", at)
        self.db = corpus_mod.build_database(self.corpus)
        at = self._stage("database", at)
        self.engine = lapis_silo_torch.install(self.db, device)
        self._sync()
        at = self._stage("engine_build_and_upload", at)
        self.at = at
        self.generator = corpus_mod.generator_for(self.mix, self.corpus, seed)
        self.loop = self.mix["loop"]
        self.clients = self.loop.get("clients") or self.loop["workers"]
        self.flat_words = self.engine.n_flat_words

    @staticmethod
    def _stage(name: str, since: float) -> float:
        now = time.perf_counter()
        log(f"setup {name}: {now - since:.3f} s")
        return now

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def execute(self, request):
        return self.db.execute_query(request.body)

    def traffic(self, seconds: float, stream: int = 1):
        """The window's requests, and in an open loop their arrivals."""
        if self.loop["kind"] == "open":
            arrivals = self.generator.arrivals(self.loop["rate_per_s"],
                                               seconds)
            return self.generator.requests(len(arrivals), stream), arrivals
        requests = self.generator.stream(stream)
        requests.prefetch(int(seconds * self.mix["prefetch_per_s"]))
        return requests, None

    def warm(self) -> None:
        """The cell's routes, with requests of its own mix (another stream
        than the window's), and a cache of leaves with every leaf of a
        fixed working set, twice."""
        from benchmark.load import closed
        warm = self.generator.requests(self.mix["warmup_requests"], stream=2)
        at = self._stage("traffic", self.at)
        def none(i):
            return False
        for _ in range(self.mix.get("warmup_sweeps", 0)):
            closed(self.execute, self.generator.sweep(), self.clients, None,
                   hold=none)
        if self.mix.get("warmup_sweeps"):
            at = self._stage("pool_warmup", at)
        closed(self.execute, warm, self.clients, None, hold=none)
        self._sync()
        self._stage("route_warmup", at)
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats(self.device)
        gc.collect()

    def drive(self, requests, arrivals, seconds: float, trace: bool) -> Run:
        """One window of load, with the program's counters at its open and
        close (`counters`, with the probes of the run's readers); with
        `trace` the port's spans too, and the card's timeline where the run
        reads it (`records_timeline`)."""
        from benchmark.load import GRACE_S, closed, open_
        from benchmark.tracing import Trace

        tracer = (Trace() if records_timeline(self.spec, self.workload, trace)
                  else None)
        if trace:
            tracer.attach(self.engine)
        probes = counter_probes(self.spec, self.workload, trace)
        marks = {"open": counters(self.engine, probes)}

        def close():
            marks["close"] = counters(self.engine, probes)
            if tracer is not None:
                tracer.stop(self.device)

        hold = None
        if arrivals is None:
            hold = holder(self.seed, int(seconds * self.mix["prefetch_per_s"]),
                          sum(self.mix["check"].values()))
        setup_s = time.perf_counter() - PROCESS_START
        if tracer is not None:
            tracer.start(self.device)
        lateness = []
        if arrivals is None:
            records, t0, t1 = closed(self.execute, requests, self.clients,
                                     seconds, close, hold)
        else:
            records, t0, t1, lateness = open_(self.execute, requests, arrivals,
                                              self.clients, seconds, close)
        if trace:
            tracer.detach(self.engine)
        return Run(records, t0, t1, GRACE_S, setup_s, self.flat_words,
                   {name: (marks["open"][name], marks["close"][name])
                    for name in marks["open"]}, tracer, lateness)

    def release(self) -> None:
        """Drop the program's state: the reference runs after it."""
        self.db.device_engine = None
        self.db._engine = None
        self.engine = self.db = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def check(corpus_mod, corpus, mix: dict, seed: int, records, requests,
          answer=None) -> dict:
    """The checks of `correct`, each (number, limit): the sample's answers
    the reference (`corpus_mod`'s for `corpus`) finds wrong, the requests
    that failed, those never answered, and the mix's kinds with no answer
    checked. `answer` (a query's body to its rows) stands in for the served
    answers where given: the control's readings."""
    from benchmark.reference.compare import agrees

    started = time.perf_counter()
    reference = corpus_mod.reference_for(corpus)
    built = time.perf_counter()
    checked = sample(records, mix["check"], seed)
    wrong = []
    for r in checked:
        body = requests[r.index].body
        response = (r.response if answer is None
                    else {"queryResult": answer(body)})
        if not agrees(reference, body, response):
            wrong.append((body, response))
    log(f"reference: built in {built - started:.3f} s, {len(checked)} "
        f"answers checked in {time.perf_counter() - built:.3f} s")
    for body, response in wrong[:3]:
        log(f"wrong answer to {body[:300]}: {json.dumps(response)[:300]}")
    unchecked = sum(1 for kind in mix["check"]
                    if not any(r.kind == kind for r in checked))
    return {"wrong_answers": (len(wrong), 0),
            "errors": (sum(1 for r in records
                           if r.end is not None and r.error), 0),
            "unanswered": (sum(1 for r in records if r.end is None), 0),
            "kinds_unchecked": (unchecked, 0)}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, spec: dict | None = None) -> dict:
    """One run of the cell on `device`; returns the result's JSON object."""
    from benchmark.tracing import breakdown, busy_s

    cell = Cell(workload, seed, device, overrides, spec)
    requests, arrivals = cell.traffic(seconds)
    cell.warm()
    run = cell.drive(requests, arrivals, seconds, trace)
    torch = cell.torch
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    _report_load(run, requests)
    cell.release()
    checks = check(cell.corpus_module, cell.corpus, cell.mix, seed,
                   run.records, requests)

    metrics = {}
    for metric in metric_entries(cell.spec, workload, trace):
        value = reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    failed = checks["errors"][0] + checks["unanswered"][0]
    result = {
        "correct": all(value <= limit for value, limit in checks.values()),
        "attempted": len(run.records), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": memory_peak},
    }
    tracer = run.trace
    if trace and tracer.device_events:
        result["device"]["busy_s"] = busy_s(
            tracer.device_events, tracer.t0_ns, tracer.t1_ns)
        result["device"]["window_s"] = tracer.window_s
        result["breakdown"] = breakdown(tracer)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, (value, limit) in checks.items()}
    return result


def _report_load(run: Run, requests) -> None:
    """Readings beside the metrics, on standard error."""
    from benchmark.stats import percentile
    done = [r for r in run.records if r.ok]
    log(f"window: {run.t1 - run.t0:.3f} s, {len(run.records)} requests, "
        f"{len(done)} answered ({sum(1 for r in done if r.end <= run.t1)} "
        f"inside the window)")
    by_kind: dict[str, list[float]] = {}
    for r in done:
        by_kind.setdefault(r.kind, []).append((r.end - r.due) * 1e3)
    for kind, times in sorted(by_kind.items()):
        log(f"latency {kind}: n={len(times)} p50={percentile(times, 50):.3f} "
            f"p95={percentile(times, 95):.3f} max={max(times):.3f} ms")
    if run.lateness:
        late = [s * 1e3 for s in run.lateness]
        log(f"generator lateness: p50={percentile(late, 50):.3f} "
            f"p99={percentile(late, 99):.3f} max={max(late):.3f} ms")
    for name in run.counters:
        log(f"counter {name}: {run.counter(name)}")
    failed = [r for r in run.records if r.error]
    if failed:
        log(f"{len(failed)} requests failed, the first: "
            f"{requests[failed[0].index].body[:300]}: {failed[0].error}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_spec()
    chips = by_name(spec["workloads"], args.workload)["chips"]
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}")
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), spec=spec)
    loaded = sorted({name.split(".")[0] for name in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        log(f"refused: the process loaded {', '.join(loaded)}")
        return 3
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']} (limit {check['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
