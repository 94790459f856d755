"""The one generator of the benchmark's traffic: it reads a mix
(``traffic/<name>.json``) and draws the requests, in order, from a seed.

A mix names its loop, the kinds of request with their shares, and for each
kind its action and the filter shapes it rotates through. A shape is a
filter expression in SILO's JSON in which these strings stand for leaves
drawn afresh for every request:

- ``"$leaf"``: a mutation, ``NucleotideEquals`` of the position's
  non-reference symbol or ``HasNucleotideMutation``, the latter with the
  mix's ``has_mutation_share``;
- ``"$nuc"``: a ``NucleotideEquals`` of the position's non-reference symbol;
- ``"$country"``: ``StringEquals`` on ``country``;
- ``"$dates"``: ``DateBetween`` on ``date``, a span of ``date_span_days``.

Positions are uniform over the genome, or drawn from a fixed set of
``size`` positions that the seed chooses (``"positions"``). A kind's
``and_metadata_share`` of its requests wraps the filter as ``And(filter,
$country, $dates)``, every request alike.

Every seed gets the same requests in number and kind, and in an open loop
the same gaps between arrivals (the quantiles of an exponential law at the
mix's rate), in an order the seed shuffles.
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MIX_DIR = Path(__file__).resolve().parent
PLACEHOLDERS = ("$leaf", "$nuc", "$country", "$dates")
SYMBOLS = "-ACGT"


@dataclass
class Request:
    kind: str
    body: str


def load_mix(name: str) -> dict:
    return json.loads((MIX_DIR / f"{name}.json").read_text())


def _template(shape) -> tuple[str, list[str]]:
    """A shape as a format string and its placeholders in order."""
    text = json.dumps(shape, separators=(",", ":"))
    text = text.replace("{", "{{").replace("}", "}}")
    order = []
    out = []
    i = 0
    while i < len(text):
        for name in PLACEHOLDERS:
            token = f'"{name}"'
            if text.startswith(token, i):
                order.append(name)
                out.append("{}")
                i += len(token)
                break
        else:
            out.append(text[i])
            i += 1
    return "".join(out), order


class Generator:
    """Draws a mix's requests for one corpus geometry: `reference` holds the
    symbol ids (1..4) of the genome, `countries` the metadata's values,
    `year` and `month` the month every sequence was collected in, of
    `n_days` days."""

    def __init__(self, mix: dict, reference, countries, year: int,
                 month: int, n_days: int, seed: int):
        self.mix = mix
        self.reference = np.asarray(reference, dtype=np.int64)
        self.countries = list(countries)
        self.year, self.month, self.n_days = year, month, n_days
        self.seed = seed
        positions = mix.get("positions", {"kind": "uniform"})
        rng = np.random.default_rng([seed, 0])
        if positions["kind"] == "fixed_set":
            self.position_set = np.sort(rng.choice(
                len(self.reference), size=positions["size"], replace=False))
        elif positions["kind"] == "uniform":
            self.position_set = None
        else:
            raise ValueError(f"positions {positions['kind']!r}")
        self.kinds = mix["kinds"]
        self.templates = {kind["name"]: [_template(s) for s in kind["filters"]]
                          for kind in self.kinds}

    # -- leaves ----------------------------------------------------------------

    def _positions(self, rng, n: int) -> np.ndarray:
        if self.position_set is None:
            return rng.integers(0, len(self.reference), size=n)
        return self.position_set[rng.integers(0, len(self.position_set),
                                              size=n)]

    def _nuc(self, position: int) -> str:
        symbol = SYMBOLS[int(self.reference[position]) % 4 + 1]
        return (f'{{"type":"NucleotideEquals","position":{position + 1},'
                f'"symbol":"{symbol}"}}')

    def _leaves(self, rng, name: str, n: int) -> list[str]:
        if name in ("$leaf", "$nuc"):
            positions = self._positions(rng, n)
            has = (rng.random(n) < self.mix.get("has_mutation_share", 0.0)
                   if name == "$leaf" else np.zeros(n, dtype=bool))
            return [(f'{{"type":"HasNucleotideMutation","position":{p + 1}}}'
                     if h else self._nuc(p))
                    for p, h in zip(positions.tolist(), has.tolist())]
        if name == "$country":
            picks = rng.integers(0, len(self.countries), size=n)
            return [f'{{"type":"StringEquals","column":"country",'
                    f'"value":"{self.countries[i]}"}}' for i in picks.tolist()]
        lo, hi = self.mix.get("date_span_days", [1, self.n_days])
        spans = rng.integers(lo, hi + 1, size=n)
        starts = rng.integers(1, self.n_days + 1, size=n)
        prefix = f"{self.year:04d}-{self.month:02d}-"
        return [f'{{"type":"DateBetween","column":"date",'
                f'"from":"{prefix}{s:02d}","to":"{prefix}'
                f'{min(self.n_days, s + w - 1):02d}"}}'
                for s, w in zip(starts.tolist(), spans.tolist())]

    # -- requests --------------------------------------------------------------

    def _kind_requests(self, rng, kind: dict, n: int) -> list[Request]:
        action = json.dumps(kind["action"], separators=(",", ":"))
        templates = self.templates[kind["name"]]
        share = kind.get("and_metadata_share", 0.0)
        wrapped = [math.floor((i + 1) * share) > math.floor(i * share)
                   for i in range(n)]
        # the placeholders of every request, drawn per placeholder kind
        wanted = {name: 0 for name in PLACEHOLDERS}
        for i in range(n):
            for name in templates[i % len(templates)][1]:
                wanted[name] += 1
            if wrapped[i]:
                wanted["$country"] += 1
                wanted["$dates"] += 1
        pools = {name: iter(self._leaves(rng, name, count))
                 for name, count in wanted.items() if count}
        out = []
        for i in range(n):
            fmt, names = templates[i % len(templates)]
            text = fmt.format(*(next(pools[name]) for name in names))
            if wrapped[i]:
                text = (f'{{"type":"And","children":[{text},'
                        f'{next(pools["$country"])},{next(pools["$dates"])}]}}')
            out.append(Request(kind["name"], f'{{"action":{action},'
                                             f'"filterExpression":{text}}}'))
        return out

    def requests(self, n: int, stream: int = 1,
                 part: int = 0) -> list[Request]:
        """`n` requests, each kind's share of them exactly (the remainder to
        the kinds listed first), shuffled by the seed; another `stream`
        draws other requests of the same mix (the warm-up's), another
        `part` the stream's next requests."""
        rng = np.random.default_rng([self.seed, stream] if part == 0
                                    else [self.seed, stream, part])
        counts = [int(n * kind["share"]) for kind in self.kinds]
        for i in range(n - sum(counts)):
            counts[i % len(counts)] += 1
        out = []
        for kind, count in zip(self.kinds, counts):
            out.extend(self._kind_requests(rng, kind, count))
        if len(self.kinds) > 1:
            out = [out[i] for i in rng.permutation(len(out))]
        return out

    def stream(self, stream: int = 1, chunk: int = 65536) -> "RequestStream":
        """The requests of a closed loop: as many as its clients take, none
        twice."""
        return RequestStream(self, stream, chunk)

    def sweep(self) -> list[Request]:
        """One count per position of the fixed set touching every leaf the
        mix can draw there: what warms a cache of leaves."""
        if self.position_set is None:
            return []
        return [Request("sweep", '{"action":{"type":"Aggregated"},'
                        '"filterExpression":{"type":"Or","children":['
                        f'{{"type":"HasNucleotideMutation","position":{p + 1}}},'
                        f'{self._nuc(p)}]}}}}')
                for p in self.position_set.tolist()]

    def arrivals(self, rate: float, seconds: float) -> np.ndarray:
        """Arrival offsets in [0, seconds) of an open loop at `rate`: the
        quantiles of the exponential gap, scaled to fill the window, in an
        order the seed shuffles."""
        n = max(1, round(rate * seconds))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
        gaps *= seconds / gaps.sum()
        gaps = gaps[np.random.default_rng([self.seed, 3]).permutation(n)]
        return np.concatenate(([0.0], np.cumsum(gaps)[:-1]))


class RequestStream:
    """A stream's requests by index, drawn `chunk` at a time (part k of the
    stream holds requests k * chunk onwards) the first time an index asks
    for them: ``prefetch`` draws ahead of a window, and a program faster
    than that is sent fresh requests all the same. The requests are held
    as lists of strings, which the collector does not traverse: the harness
    adds no objects to the program's collections."""

    def __init__(self, generator: Generator, stream: int, chunk: int):
        self.generator, self.stream_id, self.chunk = generator, stream, chunk
        self.parts: list[tuple[list[str], list[str]]] = []  # kinds, bodies
        self.lock = threading.Lock()

    def prefetch(self, n: int) -> None:
        with self.lock:
            while len(self.parts) * self.chunk < n:
                drawn = self.generator.requests(self.chunk, self.stream_id,
                                                len(self.parts))
                self.parts.append(([r.kind for r in drawn],
                                   [r.body for r in drawn]))

    def __getitem__(self, i: int) -> Request:
        part, offset = divmod(i, self.chunk)
        if part >= len(self.parts):
            self.prefetch((part + 1) * self.chunk)
        kinds, bodies = self.parts[part]
        return Request(kinds[offset], bodies[offset])
