"""Peaks of the card and the least work of a VM launch, counted from the
queries it answered and the corpus' shape, whatever implements them."""

from __future__ import annotations

import json

# NVIDIA H100 SXM5 80GB data sheet: HBM3 bandwidth, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12

_COMBINATORS = {"And": "children", "Or": "children", "N-Of": "children",
                "Not": "child"}


def leaves(node, out: set | None = None) -> set:
    """The distinct inputs a filter reads: one per (position, symbol) of a
    NucleotideEquals, per position of a HasNucleotideMutation, and per
    metadata predicate."""
    out = set() if out is None else out
    kind = node["type"]
    if kind in _COMBINATORS:
        children = node[_COMBINATORS[kind]]
        for child in children if isinstance(children, list) else [children]:
            leaves(child, out)
    elif kind == "NucleotideEquals":
        out.add(("nuc", node["position"], node["symbol"]))
    elif kind == "HasNucleotideMutation":
        out.add(("has", node["position"]))
    elif kind not in ("True", "False"):
        out.add(("meta", json.dumps(node, sort_keys=True)))
    return out


def launch_bytes(filters: list[str], flat_words: int) -> int:
    """The least bytes a count launch moves: one flat bitmap (4 bytes a word
    over every partition) per distinct input of its queries, read once,
    and one 4-byte count written per query. `filters` are the queries'
    filter expressions as JSON."""
    distinct: set = set()
    for text in filters:
        leaves(json.loads(text), distinct)
    return 4 * flat_words * len(distinct) + 4 * len(filters)


def vm_roofline_pct(run):
    """The least time of the window's count launches at the card's
    bandwidth over the VM kernels' time on the card, in %; None without a
    timeline, VM time or launch."""
    if run.trace is None or not run.trace.device_events:
        return None
    vm_s = sum(end - start for name, start, end in run.trace.device_events
               if "vm_run" in name) / 1e9
    launches = [keys for at, keys in run.trace.launches
                if run.trace.in_window(at)]
    if not vm_s or not launches:
        return None
    least = sum(launch_bytes(keys, run.flat_words)
                for keys in launches) / HBM_BYTES_PER_S
    return 100.0 * least / vm_s
