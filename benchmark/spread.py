#!/usr/bin/env python3
"""The spread of repeated runs, as the bounds of BENCHMARK.json are set
from it: for each metric, each set's distance between the first and the
third quartile over its median, and five times the wider of them.

    python3 benchmark/spread.py setA/*.out -- setB/*.out

Each file's last line is a run's result.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.stats import spread  # noqa: E402


def values(paths) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for path in paths:
        result = json.loads(Path(path).read_text().strip().splitlines()[-1])
        for name, metric in result["metrics"].items():
            out.setdefault(name, []).append(metric["value"])
    return out


def main(argv) -> int:
    cut = argv.index("--") if "--" in argv else len(argv)
    sets = [values(argv[:cut]), values(argv[cut + 1:])] if cut < len(
        argv) else [values(argv)]
    for name in sets[0]:
        spreads = [spread(s[name]) for s in sets if len(s.get(name, [])) > 1]
        medians = [sorted(s[name])[len(s[name]) // 2] for s in sets]
        print(f"{name}: medians {medians}, spreads "
              f"{[round(x, 4) for x in spreads]}, five times the wider "
              f"{5 * max(spreads):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
