"""A dashboard's variant page over the lineage corpus: the corpus and the
port's database are ``benchmark/lineage.py``'s, the generator draws pages,
and the reference (``reference/dashboard.py``) answers the counts and
group-bys beside the Mutations.

A page is what a GenSpectrum dashboard's variant page asks of LAPIS, and
LAPIS of SILO, for one lineage with its sublineages over a window of days,
in one country or in all: the variant's count (``gs-statistics``), the
baseline's count, both by date (``gs-prevalence-over-time``), the
variant by country (``gs-aggregate``), and its nucleotide and amino-acid
mutations (``gs-mutations``). The baseline is the variant's filter without
the lineage. The mix's ``kinds`` give the seven requests in the order a
page sends them, each with its action and whether it asks of the variant
or of the baseline.

The module is a corpus module (``benchmark/run.py``'s ``CORPUS_CONTRACT``):
``draw_for``, ``build_database``, ``generator_for``, ``reference_for`` and
``stale_reference_for``. Only ``build_database`` imports the port.
"""

from __future__ import annotations

import json

import numpy as np

from benchmark.lineage import Corpus, LineageGenerator
from benchmark.lineage import build_database as build_lineage_database
from benchmark.lineage import draw_for  # noqa: F401 — the contract's
from benchmark.reference.dashboard import (
    DashboardReference, StaleDashboardReference,
)
from benchmark.roofline_groupby import least_bytes


def build_database(corpus: Corpus):
    """The lineage corpus' database (``lineage.build_database``), with the
    least bytes of a group-by by each column the page groups by
    (``roofline_groupby.least_bytes``) kept on it as
    ``least_group_bytes``, which ``groupby_roofline_pct`` reads."""
    db = build_lineage_database(corpus)
    db.least_group_bytes = least_bytes(corpus)
    return db


def generator_for(mix: dict, corpus: Corpus, seed: int) -> "PageGenerator":
    """The generator of the mix's requests over this corpus."""
    return PageGenerator(mix, corpus, seed)


def reference_for(corpus: Corpus) -> DashboardReference:
    """The plain reference that the comparison of ``correct`` reads."""
    return DashboardReference(corpus)


def stale_reference_for(corpus: Corpus) -> StaleDashboardReference:
    """The control: the reference a release behind."""
    return StaleDashboardReference(corpus)


class PageGenerator(LineageGenerator):
    """Draws the variant pages of a mix (``traffic/variant_page.json``) over
    a lineage corpus, in order, from a seed: request i of a stream is kind
    i mod 7 of page i div 7. A page's lineage and window are
    ``LineageGenerator``'s: a window of D days (D from the mix's
    ``window_days``) which on every second page, from the first, ends on
    the snapshot's newest day, the lineage drawn in proportion to its
    clade's genomes in it, and on the others lies inside the clade's own
    days. Pages 4m and 4m + 1 name a country, drawn in proportion to the
    corpus' genomes of each (which the configuration's weights drew), pages
    4m + 2 and 4m + 3 none: half of each kind of window names one. A page
    whose variant filter selects no genome, or that a stream of the
    generator (the window's or the warm-up's) has drawn before, is drawn
    again; baselines repeat across pages. The lineage is written as the
    metadata holds it, aliased where an alias exists."""

    def __init__(self, mix: dict, corpus: Corpus, seed: int):
        super().__init__(mix, corpus, seed)
        self.reference = DashboardReference(corpus)
        weights = np.bincount(corpus.country.astype(np.int64),
                              minlength=len(corpus.countries))
        self.country_p = weights / weights.sum()
        # per clade: its genomes per country, summed up to each day
        self._by_country: dict[int, np.ndarray] = {}
        # per stream: its pages in order (the variants drawn: ``_sent``)
        self._pages: dict[int, list] = {}

    def _chosen(self, lineage: int, lo: int, hi: int, country: str) -> int:
        """The genomes the variant filter selects in `country`."""
        upto = self._by_country.get(lineage)
        if upto is None:
            corpus = self.corpus
            clade = self.reference._lineages(corpus.tree.names[lineage],
                                             True)[corpus.lineage]
            width = corpus.n_days + 1
            counts = np.bincount(
                corpus.country[clade].astype(np.int64) * width
                + corpus.day[clade] + 1,
                minlength=len(corpus.countries) * width)
            upto = self._by_country[lineage] = np.cumsum(
                counts.reshape(-1, width), axis=1).astype(np.int32)
        k = self.corpus.countries.index(country)
        return int(upto[k, hi + 1] - upto[k, lo])

    def _page(self, rng, recent: bool, local: bool) -> tuple:
        """(lineage, first day, last day, country or None) of one page."""
        countries = self.corpus.countries
        while True:
            lineage, lo, hi = self._filter(rng, recent)
            if not local:
                return lineage, lo, hi, None
            country = countries[int(rng.choice(len(countries),
                                               p=self.country_p))]
            if self._chosen(lineage, lo, hi, country) > 0:
                return lineage, lo, hi, country

    def _filters(self, lineage: int, lo: int, hi: int, country) -> dict:
        """{"variant": filter JSON, "baseline": filter JSON}."""
        f = self.filter
        rest = (f'{{"type":"DateBetween","column":"{f["date_column"]}",'
                f'"from":"{self.corpus.date_text(lo)}",'
                f'"to":"{self.corpus.date_text(hi)}"}}')
        if country is not None:
            rest += (f',{{"type":"StringEquals","column":'
                     f'"{f["country_column"]}","value":"{country}"}}')
        lineage_filter = (
            f'{{"type":"PangoLineage","column":"{f["lineage_column"]}",'
            f'"value":"{self.corpus.tree.names[lineage]}",'
            f'"includeSublineages":{json.dumps(f["include_sublineages"])}}}')
        return {"variant": f'{{"type":"And","children":[{lineage_filter},'
                           f'{rest}]}}',
                "baseline": f'{{"type":"And","children":[{rest}]}}'}

    def _draw_pages(self, stream: int, n_pages: int) -> list:
        """The stream's first `n_pages` pages (under the lock), drawing the
        ones not drawn yet in order, page j from its own generator."""
        pages, sent = self._pages[stream], self._sent[stream]
        other = set().union(*(variants for key, variants
                              in self._sent.items() if key != stream))
        while len(pages) < n_pages:
            j = len(pages)
            rng = np.random.default_rng([self.seed, stream, j])
            for _ in range(100000):
                filters = self._filters(*self._page(rng, j % 2 == 0,
                                                    j // 2 % 2 == 0))
                if (filters["variant"] not in sent
                        and filters["variant"] not in other):
                    break
            else:
                raise RuntimeError(f"stream {stream} has drawn every "
                                   f"distinct page of its kind")
            sent.add(filters["variant"])
            pages.append(filters)
        return pages

    def requests(self, n: int, stream: int = 1, part: int = 0) -> list:
        """`n` requests of `stream`; another `part` gives the stream's next
        requests (part k from request k * n on, as ``RequestStream`` asks
        for them). Part 0 draws the stream afresh."""
        from benchmark.traffic.generator import Request
        first = part * n
        per_page = len(self.kinds)
        with self._lock:
            if part == 0:
                self._pages[stream], self._sent[stream] = [], set()
            pages = self._draw_pages(stream, -(-(first + n) // per_page))
        out = []
        for i in range(first, first + n):
            page, k = divmod(i, per_page)
            kind = self.kinds[k]
            out.append(Request(kind["name"], (
                f'{{"action":{self.actions[k]},"filterExpression":'
                f'{pages[page][kind["filter"]]}}}')))
        return out
