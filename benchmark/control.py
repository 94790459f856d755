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

from benchmark.load import Record  # noqa: E402
from benchmark.run import (  # noqa: E402
    cell_files, check, corpus_module, load_spec,
)


def readings(workload: str, seed: int, seconds: float,
             overrides=None, spec=None) -> dict:
    """The checks of a run whose every answer the control gave."""
    config, mix = cell_files(spec or load_spec(), workload, overrides)
    corpus_mod = corpus_module(config)
    corpus = corpus_mod.draw_for(config, seed)
    generator = corpus_mod.generator_for(mix, corpus, seed)
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
    stale = corpus_mod.stale_reference_for(corpus)
    return check(corpus_mod, corpus, mix, seed, records, requests,
                 answer=stale.answer)


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
