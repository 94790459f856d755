#!/usr/bin/env python3
"""The control's readings at a cell's own size: the stale reference
(``reference/control.py``) answers the window's requests in the program's
place, and the comparison that decides ``correct`` counts what it gets
wrong. No program runs, so no card is needed.

    python3 benchmark/control.py --workload dense1m.counts --seconds 10 --seeds 1 2 3

Per seed it prints the checks as a run prints them; the control has to
fail, which takes a wrong answer.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import corpus as corpus_mod  # noqa: E402
from benchmark.load import Record  # noqa: E402
from benchmark.reference.control import StaleReference  # noqa: E402
from benchmark.run import cell_files, check, load_spec  # noqa: E402
from benchmark.traffic.generator import Generator  # noqa: E402


def readings(workload: str, seed: int, seconds: float,
             overrides=None, spec=None) -> dict:
    """The checks of a run whose every answer the control gave."""
    config, mix = cell_files(spec or load_spec(), workload, overrides)
    corpus = corpus_mod.draw(
        config["n_sequences"], config["sequence_length"],
        config["n_partitions"], config["mutations_per_genome"], seed)
    generator = Generator(mix, corpus.reference, corpus_mod.COUNTRIES,
                          corpus_mod.YEAR, corpus_mod.MONTH,
                          corpus_mod.N_DAYS, seed)
    loop = mix["loop"]
    if loop["kind"] == "open":
        n = len(generator.arrivals(loop["rate_per_s"], seconds))
        requests = generator.requests(n)
    else:
        # as many requests as a run draws ahead of its window
        n = max(1, int(seconds * mix["prefetch_per_s"]))
        requests = generator.stream()
        requests.prefetch(n)
    records = [Record(i, requests[i].kind, 0.0, 0.0, 0.0) for i in range(n)]
    stale = StaleReference(corpus, corpus_mod.COUNTRIES, corpus_mod.YEAR,
                           corpus_mod.MONTH)
    return check(corpus, mix, seed, records, requests, answer=stale.answer)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    for seed in args.seeds:
        checks = readings(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
