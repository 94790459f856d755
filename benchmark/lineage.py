"""The lineage corpus: a SARS-CoV-2 deployment partitioned by Pango lineage,
with the nucleotide segment ``main`` and the amino-acid genes, drawn from a
seed.

The deployment's lineage nomenclature is its shape, drawn once from the
configuration's ``lineages.tree_seed``: a tree of Pango lineages named by
the Pango grammar (``B.1.1.529``; a child that would pass three numeric
levels takes an alias, ``BA.1``, recorded in the alias table), each with
its circulation window inside the collection days, its share of the
genomes (heavy-tailed, so clade sizes are too), how many nucleotide and
amino-acid mutations define it and in which genes the latter fall. Every
run's ``--seed`` draws the rest: the
references, where each lineage's defining mutations fall and what they
change to, each genome's collection day inside its lineage's window and
its country, each genome's private mutations, its run of N and its run of
X. A genome carries every defining mutation on its lineage's path from the
root (a later one at the same position replacing the earlier), then its
private mutations, then its runs of N (``main``) and X (a gene), each
replacing what it covers; private mutations are drawn outside the genome's
own run.

Partitions follow SILO's preprocessor (``partitionBy``): the distinct
lineage values (aliased, as the metadata holds them) in ascending order,
bin-packed greedily into chunks of about N/32, each lineage whole in one;
within a partition the genomes are sorted by date. As SILO's ingest does,
each partition's most numerous symbol at a position is implicit, and every
other (symbol, position) holding a genome is a stored row
(``stored_rows``).

The module is a corpus module (``benchmark/run.py``'s ``CORPUS_CONTRACT``):
``draw_for``, ``build_database``, ``generator_for``, ``reference_for`` and
``stale_reference_for``. Only ``build_database`` imports the port.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from benchmark.reference.lineage import LineageReference, StaleLineageReference

# symbol ids of the corpus, by alphabet: the valid symbols, then the
# missing one (N, X); the references hold plain symbols only
NUC_CHARS = "-ACGTN"
AA_CHARS = "-ACDEFGHIKLMNPQRSTVWY*X"
ALPHABETS = {"nuc": NUC_CHARS, "aa": AA_CHARS}
PLAIN = {"nuc": (1, 4), "aa": (1, 20)}  # symbol ids a reference draws from
MISSING = {"nuc": len(NUC_CHARS) - 1, "aa": len(AA_CHARS) - 1}
# the metadata's column names
LINEAGE_COLUMN, DATE_COLUMN = "pangoLineage", "date"


@dataclass
class Segment:
    kind: str  # "nuc" or "aa"
    name: str
    reference: np.ndarray  # uint8 [length] symbol ids

    @property
    def length(self) -> int:
        return len(self.reference)

    @property
    def chars(self) -> str:
        return ALPHABETS[self.kind]


@dataclass
class Tree:
    """The lineage nomenclature, in creation order (a parent before its
    children), with how many nucleotide mutations define each lineage and
    in which genes its amino-acid ones fall."""
    unaliased: list[str]
    names: list[str]  # as the metadata holds them: aliased where one exists
    parent: np.ndarray  # int64 [n], -1 for a root
    alias_key: dict[str, list[str]]
    start: np.ndarray  # int64 [n] first and last day of circulation
    end: np.ndarray
    genomes: np.ndarray  # int64 [n] genomes of the lineage itself
    n_nuc: np.ndarray  # int64 [n] defining nucleotide mutations
    aa_genes: list  # per lineage: int64 [k] the gene of each of its
    # defining amino-acid mutations (an index into the configuration's)

    def __len__(self) -> int:
        return len(self.names)


@dataclass
class Corpus:
    """Genome i is row i - bounds[p] of partition p for bounds[p] <= i <
    bounds[p + 1]. Per segment name: ``paths`` (lineage, position, symbol)
    of every lineage's path mutations, sorted by lineage then position;
    ``private`` (genome, position, symbol, base) sorted by genome then
    position, base the symbol the path gives there; ``runs`` (genome,
    start, end) of the runs of the missing symbol, end exclusive, sorted
    by genome, at most one a genome and segment."""
    segments: list[Segment]
    tree: Tree
    first_day: datetime.date
    n_days: int
    countries: list[str]
    bounds: np.ndarray  # int64 [P + 1]
    lineage: np.ndarray  # int32 [n]
    day: np.ndarray  # int32 [n]
    country: np.ndarray  # int8 [n]
    paths: dict
    private: dict
    runs: dict

    @property
    def n_rows(self) -> int:
        return int(self.bounds[-1])

    @property
    def n_partitions(self) -> int:
        return len(self.bounds) - 1

    def segment(self, name: str) -> Segment:
        return next(s for s in self.segments if s.name == name)

    def date_text(self, day: int) -> str:
        return (self.first_day + datetime.timedelta(days=int(day))).isoformat()


# -- the nomenclature -----------------------------------------------------------

def _alias_names():
    """Pango's alias letters in order: single letters C-Z, then two letters,
    skipping I and O and the recombinants' X."""
    letters = [c for c in "ABCDEFGHJKLMNPQRSTUVWYZ"]
    for c in letters[2:]:
        yield c
    for a in letters:
        for b in letters:
            yield a + b


def draw_tree(spec: dict, n_genomes: int, n_days: int,
              gene_lengths: list[int]) -> Tree:
    """The nomenclature of ``spec`` (the configuration's ``lineages``),
    drawn from its ``tree_seed`` alone. Each new lineage descends from an
    earlier one picked in proportion to its share of the genomes. The
    shares are the quantiles of a Pareto law, capped at ``max_share``, in
    an order the seed shuffles; the genomes are split by them with the
    largest remainders, so every seed of the runs has the same lineage
    sizes and partitions. Each lineage's defining amino-acid mutations fall
    in genes picked by their lengths, also here: which genes a dominant
    clade changes decides which genes hold dense rows, and with them how
    many launches a query's reduction makes."""
    rng = np.random.default_rng(spec["tree_seed"])
    n = spec["count"]
    roots = spec["roots"]
    quantiles = (np.arange(n) + 0.5) / n
    weights = quantiles ** (-1.0 / spec["pareto_shape"])
    weights = weights[rng.permutation(n)]
    cap = spec["max_share"] * weights.sum()
    weights = np.minimum(weights, cap)
    share = weights / weights.sum() * n_genomes
    genomes = np.floor(share).astype(np.int64)
    left = n_genomes - int(genomes.sum())
    genomes[np.argsort(genomes - share, kind="stable")[:left]] += 1

    parent = np.full(n, -1, dtype=np.int64)
    cumulative = np.cumsum(weights)
    picks = rng.random(n)
    unaliased, names = list(roots), list(roots)
    children = [0] * n
    alias_of: dict[int, str] = {}
    alias_key: dict[str, list[str]] = {}
    aliases = _alias_names()
    lo_dur, hi_dur = spec["window_days"]
    start = np.zeros(n, dtype=np.int64)
    duration = rng.integers(lo_dur, hi_dur + 1, size=n)
    duration[:len(roots)] = n_days
    delays = rng.random(n)
    for i in range(len(roots), n):
        p = int(np.searchsorted(cumulative[:i], picks[i] * cumulative[i - 1],
                                side="right"))
        parent[i] = p
        children[p] += 1
        unaliased.append(f"{unaliased[p]}.{children[p]}")
        if names[p].count(".") >= 3:  # the child would pass three levels
            if p not in alias_of:
                alias_of[p] = next(aliases)
                alias_key[alias_of[p]] = [unaliased[p]]
            names.append(f"{alias_of[p]}.{children[p]}")
        else:
            names.append(f"{names[p]}.{children[p]}")
        start[i] = min(start[p] + int(delays[i] * (duration[p] + 1)),
                       n_days - lo_dur)
    end = np.minimum(start + duration - 1, n_days - 1)
    lo_nuc, hi_nuc = spec["nucleotide_mutations"]
    lo_aa, hi_aa = spec["amino_acid_mutations"]
    n_nuc = rng.integers(lo_nuc, hi_nuc + 1, size=n)
    n_aa = rng.integers(lo_aa, hi_aa + 1, size=n)
    lengths = np.asarray(gene_lengths, dtype=np.float64)
    aa_genes = [rng.choice(len(lengths), size=int(k), p=lengths / lengths.sum())
                for k in n_aa]
    return Tree(unaliased, names, parent, alias_key, start, end, genomes,
                n_nuc, aa_genes)


def partition_lineages(tree: Tree, max_partitions: int) -> list[list[int]]:
    """SILO's ``partitionBy`` (preprocessor.cpp:174-199): the distinct
    values in ascending order, a chunk taking the next value while its
    count is at most N / max_partitions."""
    present = [i for i in range(len(tree)) if tree.genomes[i]]
    present.sort(key=lambda i: tree.names[i])
    allowed = int(tree.genomes.sum()) / max_partitions
    groups, current, count = [], [], 0
    for i in present:
        if current and count > allowed:
            groups.append(current)
            current, count = [], 0
        current.append(i)
        count += int(tree.genomes[i])
    groups.append(current)
    return groups


# -- one run's draw -------------------------------------------------------------

def _mutate(rng, kind: str, current: np.ndarray, reference: np.ndarray,
            deletion_share: float = 0.0) -> np.ndarray:
    """A symbol other than `current` and, where the reference differs from
    it, other than the reference too: a deletion with `deletion_share`,
    else a plain symbol."""
    lo, hi = PLAIN[kind]
    width = hi - lo + 1
    out = np.empty(len(current), dtype=np.uint8)
    for i, (cur, ref) in enumerate(zip(current.tolist(), reference.tolist())):
        if deletion_share and cur != 0 and rng.random() < deletion_share:
            out[i] = 0
            continue
        banned = {cur, ref}
        choices = [s for s in range(lo, lo + width) if s not in banned]
        out[i] = choices[int(rng.integers(0, len(choices)))]
    return out


def _paths(rng, tree: Tree, segments: list[Segment], deletion_share: float):
    """Every lineage's path mutations per segment: (lineage, position,
    symbol), sorted by lineage then position. A lineage's own mutations
    fall at uniform positions (amino-acid ones in a gene picked by its
    length) and change the symbol its parent's path holds there."""
    nuc = [s for s in segments if s.kind == "nuc"]
    genes = [s for s in segments if s.kind == "aa"]
    own: list[dict] = []  # per lineage: {segment: {position: symbol}}
    for i in range(len(tree)):
        p = int(tree.parent[i])
        path = {s.name: dict(own[p][s.name]) if p >= 0 else {}
                for s in segments}
        for segment, count in [(nuc[0], int(tree.n_nuc[i]))] + [
                (genes[g], 1) for g in tree.aa_genes[i]]:
            positions = rng.integers(0, segment.length, size=count)
            current = np.array([path[segment.name].get(
                int(q), segment.reference[q]) for q in positions],
                dtype=np.uint8)
            symbols = _mutate(rng, segment.kind, current,
                              segment.reference[positions],
                              deletion_share if segment.kind == "nuc" else 0)
            for q, s in zip(positions.tolist(), symbols.tolist()):
                path[segment.name][q] = s
        own.append(path)
    out = {}
    for segment in segments:
        lineages, positions, symbols = [], [], []
        for i, path in enumerate(own):
            items = sorted(path[segment.name].items())
            lineages.extend([i] * len(items))
            positions.extend(q for q, _ in items)
            symbols.extend(s for _, s in items)
        out[segment.name] = (np.asarray(lineages, dtype=np.int64),
                             np.asarray(positions, dtype=np.int64),
                             np.asarray(symbols, dtype=np.uint8))
    return out


def path_symbols(paths: tuple, segment: Segment, lineages: np.ndarray,
                 positions: np.ndarray) -> np.ndarray:
    """The symbol each (lineage, position) pair's path gives: its path
    mutation there, else the reference's."""
    path_lineage, path_position, path_symbol = paths
    keys = path_lineage * segment.length + path_position
    want = lineages.astype(np.int64) * segment.length + positions
    at = np.minimum(np.searchsorted(keys, want), max(len(keys) - 1, 0))
    hit = (keys[at] == want) if len(keys) else np.zeros(len(want), bool)
    return np.where(hit, path_symbol[at] if len(keys) else 0,
                    segment.reference[positions]).astype(np.uint8)


def _runs(rng, n: int, share: float, lengths, segments: list[Segment]):
    """One run of the missing symbol in `share` of the genomes, in one of
    `segments` picked by its length, its length uniform in `lengths`
    (clipped to the segment) and its place uniform: {name: (genome, start,
    end)}."""
    genomes = np.flatnonzero(rng.random(n) < share)
    seg_lengths = np.array([s.length for s in segments], dtype=np.float64)
    which = (rng.choice(len(segments), size=len(genomes),
                        p=seg_lengths / seg_lengths.sum())
             if len(segments) > 1 else np.zeros(len(genomes), np.int64))
    size = rng.integers(lengths[0], lengths[1] + 1, size=len(genomes))
    place = rng.random(len(genomes))
    out = {}
    for k, segment in enumerate(segments):
        pick = which == k
        run = np.minimum(size[pick], segment.length)
        start = (place[pick] * (segment.length - run + 1)).astype(np.int64)
        out[segment.name] = (genomes[pick].astype(np.int64), start,
                             start + run)
    return out


def _private(rng, n: int, mean: float, segments: list[Segment], paths: dict,
             lineage: np.ndarray, runs: dict):
    """Each genome's private mutations, Poisson(`mean`) of them at uniform
    positions over `segments` (a gene picked by its length), each changing
    the symbol its path gives there; none twice at one position, none
    inside the genome's own run: {name: (genome, position, symbol,
    base)}."""
    counts = rng.poisson(mean, size=n)
    genome = np.repeat(np.arange(n, dtype=np.int64), counts)
    offsets = np.concatenate(([0], np.cumsum([s.length for s in segments])))
    flat = rng.integers(0, offsets[-1], size=len(genome))
    shift = rng.random(len(genome))
    out = {}
    for k, segment in enumerate(segments):
        pick = (flat >= offsets[k]) & (flat < offsets[k + 1])
        g, q, u = genome[pick], flat[pick] - offsets[k], shift[pick]
        order = np.lexsort((q, g))
        g, q, u = g[order], q[order], u[order]
        keep = np.ones(len(g), dtype=bool)
        keep[1:] = (g[1:] != g[:-1]) | (q[1:] != q[:-1])
        run_genome, run_start, run_end = runs.get(
            segment.name, (np.zeros(0, np.int64),) * 3)
        if len(run_genome):
            at = np.minimum(np.searchsorted(run_genome, g),
                            len(run_genome) - 1)
            covered = ((run_genome[at] == g) & (q >= run_start[at])
                       & (q < run_end[at]))
            keep &= ~covered
        g, q, u = g[keep], q[keep], u[keep]
        base = path_symbols(paths[segment.name], segment, lineage[g], q)
        lo, hi = PLAIN[segment.kind]
        width = hi - lo + 1
        plain = (base >= lo) & (base <= hi)
        # a plain base moves to one of the other plain symbols; a deletion
        # to any plain symbol
        step = np.where(plain, 1 + (u * (width - 1)).astype(np.int64),
                        (u * width).astype(np.int64))
        symbol = np.where(plain, (base.astype(np.int64) - lo + step) % width
                          + lo, lo + step).astype(np.uint8)
        out[segment.name] = (g, q, symbol, base)
    return out


def draw_for(config: dict, seed: int) -> Corpus:
    """The configuration's corpus, drawn from the seed (the nomenclature
    from the configuration's own ``tree_seed``)."""
    n = int(config["n_sequences"])
    n_days = int(config["n_days"])
    tree = draw_tree(config["lineages"], n, n_days,
                     list(config["genes"].values()))
    rng = np.random.default_rng(seed)
    segments = [Segment("nuc", name, rng.integers(
        PLAIN["nuc"][0], PLAIN["nuc"][1] + 1, size=length).astype(np.uint8))
        for name, length in config["nucleotide_segments"].items()]
    segments += [Segment("aa", name, rng.integers(
        PLAIN["aa"][0], PLAIN["aa"][1] + 1, size=length).astype(np.uint8))
        for name, length in config["genes"].items()]
    paths = _paths(rng, tree, segments, config["deletion_share"])

    # genomes: lineage by the tree's sizes, the day inside its window
    # (triangular, peaking in its middle), partition-major and sorted by
    # day within a partition
    groups = partition_lineages(tree, config["max_partitions"])
    partition_of = np.zeros(len(tree), dtype=np.int64)
    for p, members in enumerate(groups):
        partition_of[members] = p
    lineage = np.repeat(np.arange(len(tree)), tree.genomes)
    span = (tree.end - tree.start + 1)[lineage]
    day = tree.start[lineage] + np.minimum(
        (rng.triangular(0.0, 0.5, 1.0, size=n) * span).astype(np.int64),
        span - 1)
    countries = config["countries"]
    weights = np.asarray(config["country_weights"], dtype=np.float64)
    country = rng.choice(len(countries), size=n, p=weights / weights.sum())
    order = np.lexsort((rng.random(n), day, partition_of[lineage]))
    lineage, day, country = lineage[order], day[order], country[order]
    bounds = np.searchsorted(partition_of[lineage],
                             np.arange(len(groups) + 1))

    nuc = [s for s in segments if s.kind == "nuc"]
    genes = [s for s in segments if s.kind == "aa"]
    runs = _runs(rng, n, config["n_run_share"], config["n_run_length"], nuc)
    runs.update(_runs(rng, n, config["x_run_share"], config["x_run_codons"],
                      genes))
    private = _private(rng, n, config["private_nucleotide_mean"], nuc, paths,
                       lineage, runs)
    private.update(_private(rng, n, config["private_amino_acid_mean"], genes,
                            paths, lineage, runs))
    return Corpus(segments, tree, datetime.date.fromisoformat(
        config["first_day"]), n_days, list(countries), bounds.astype(np.int64),
        lineage.astype(np.int32), day.astype(np.int32),
        country.astype(np.int8), paths, private, runs)


# -- the stored rows of a partition --------------------------------------------

@dataclass
class StoredRows:
    """One segment of one partition as SILO's index holds it: the implicit
    symbol of each position (``majority``), and every other (symbol,
    position) that some genome holds, as a row of bits over the
    partition's genomes, sorted by position then symbol; each row's
    non-zero words as (row, word index, word) entries."""
    majority: np.ndarray  # uint8 [length]
    positions: np.ndarray  # int64 [rows]
    symbols: np.ndarray  # uint8 [rows]
    row: np.ndarray  # int64 [entries]
    word: np.ndarray  # int64 [entries]
    bits: np.ndarray  # uint32 [entries]


def _slice(arrays: tuple, genome: np.ndarray, lo: int, hi: int) -> tuple:
    a, b = np.searchsorted(genome, [lo, hi])
    return tuple(x[a:b] for x in arrays)


def _expand(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """(owner, value) for every value of the ranges [starts, ends)."""
    lengths = ends - starts
    owner = np.repeat(np.arange(len(starts)), lengths)
    firsts = np.cumsum(lengths) - lengths
    return owner, np.arange(int(lengths.sum())) - firsts[owner] + starts[owner]


def stored_rows(corpus: Corpus, p: int, segment: Segment) -> StoredRows:
    """Partition `p`'s rows of `segment`: each genome's symbol as its
    lineage's path, its private mutations and its run give it (module
    docstring); the most numerous symbol at each position implicit (the
    reference's where no other outnumbers it, else the lowest id of the
    most numerous)."""
    lo, hi = int(corpus.bounds[p]), int(corpus.bounds[p + 1])
    n = hi - lo
    n_words = (n + 31) // 32
    length, s_count = segment.length, len(segment.chars)
    reference = segment.reference.astype(np.int64)
    local = np.arange(n, dtype=np.int64)
    lineages, member = np.unique(corpus.lineage[lo:hi], return_inverse=True)
    # each lineage's genomes as words (disjoint bits: sums are unions)
    masks = np.zeros((len(lineages), n_words), dtype=np.int64)
    np.add.at(masks, (member, local >> 5), np.int64(1) << (local & 31))

    path_lineage, path_position, path_symbol = corpus.paths[segment.name]
    at = np.searchsorted(path_lineage, lineages)
    until = np.searchsorted(path_lineage, lineages, side="right")
    owner, entry = _expand(at, until)
    path_keys = path_position[entry] * s_count + path_symbol[entry]
    keys, key_of = np.unique(path_keys, return_inverse=True)
    words = np.zeros((len(keys), n_words), dtype=np.int64)
    np.add.at(words, key_of, masks[owner])

    # the genomes whose private mutation or run replaces a path symbol
    genome, position, symbol, base = _slice(corpus.private[segment.name],
                                            corpus.private[segment.name][0],
                                            lo, hi)
    g = genome - lo
    on_path = base != reference[position]
    cleared_key = [position[on_path] * s_count + base[on_path]]
    cleared_row = [g[on_path]]
    run_genome, run_start, run_end = _slice(corpus.runs[segment.name],
                                            corpus.runs[segment.name][0],
                                            lo, hi)
    run_g = run_genome - lo
    run_lineage = corpus.lineage[run_genome].astype(np.int64)
    line_keys = path_lineage * length + path_position
    which, covered = _expand(
        np.searchsorted(line_keys, run_lineage * length + run_start),
        np.searchsorted(line_keys, run_lineage * length + run_end))
    cleared_key.append(path_position[covered] * s_count
                       + path_symbol[covered])
    cleared_row.append(run_g[which])
    cleared_key = np.concatenate(cleared_key)
    cleared_row = np.concatenate(cleared_row)
    np.subtract.at(words, (np.searchsorted(keys, cleared_key),
                           cleared_row >> 5),
                   np.int64(1) << (cleared_row & 31))

    # every genome's symbol other than the reference's, as entries
    k, w = np.nonzero(words)
    run_owner, run_position = _expand(run_start, run_end)
    entry_key = np.concatenate([
        keys[k], position * s_count + symbol,
        run_position * s_count + MISSING[segment.kind]])
    entry_word = np.concatenate([w, g >> 5, run_g[run_owner] >> 5])
    entry_bits = np.concatenate([
        words[k, w], np.int64(1) << (g & 31),
        np.int64(1) << (run_g[run_owner] & 31)])
    plain = entry_key % s_count != reference[entry_key // s_count]
    entry_key, entry_word, entry_bits = (entry_key[plain], entry_word[plain],
                                         entry_bits[plain])
    merged = entry_key * n_words + entry_word
    order = np.argsort(merged, kind="stable")
    merged = merged[order]
    first = np.ones(len(merged), dtype=bool)
    first[1:] = merged[1:] != merged[:-1]
    starts = np.flatnonzero(first)
    bits = (np.bitwise_or.reduceat(entry_bits[order], starts)
            if len(starts) else np.zeros(0, np.int64))
    merged = merged[starts]
    pair, word = merged // n_words, merged % n_words

    # the implicit symbol: the most numerous at each position
    pairs, pair_of = np.unique(pair, return_inverse=True)
    counts = np.bincount(pair_of, weights=np.bitwise_count(
        bits.astype(np.uint32)), minlength=len(pairs)).astype(np.int64)
    pair_position, pair_symbol = pairs // s_count, pairs % s_count
    others = np.bincount(pair_position, weights=counts, minlength=length)
    best = np.zeros(length, dtype=np.int64)
    np.maximum.at(best, pair_position, counts)
    majority = reference.copy()
    wins = np.flatnonzero(best > n - others)
    if len(wins):
        top = (counts == best[pair_position]) & np.isin(pair_position, wins)
        # the lowest symbol of the most numerous (pairs ascend)
        firsts = np.flatnonzero(top)
        firsts = firsts[np.unique(pair_position[firsts], return_index=True)[1]]
        majority[pair_position[firsts]] = pair_symbol[firsts]
        implicit = np.isin(pairs, pairs[firsts])
        keep = ~implicit[pair_of]
        # the reference's row there: the genomes holding no other symbol
        held = np.zeros((len(wins), n_words), dtype=np.int64)
        at_win = np.searchsorted(wins, pair_position[pair_of])
        inside = np.isin(pair_position[pair_of], wins)
        np.bitwise_or.at(held, (at_win[inside], word[inside]), bits[inside])
        full = np.full(n_words, 0xFFFFFFFF, dtype=np.int64)
        if n % 32:
            full[-1] = (1 << (n % 32)) - 1
        ref_words = full[None, :] & ~held
        rk, rw = np.nonzero(ref_words)
        pair = np.concatenate([pair[keep], wins[rk] * s_count
                               + reference[wins[rk]]])
        word = np.concatenate([word[keep], rw])
        bits = np.concatenate([bits[keep], ref_words[rk, rw]])
        order = np.lexsort((word, pair))
        pair, word, bits = pair[order], word[order], bits[order]
        pairs, pair_of = np.unique(pair, return_inverse=True)
    return StoredRows(majority.astype(np.uint8), pairs // s_count,
                      (pairs % s_count).astype(np.uint8), pair_of, word,
                      bits.astype(np.uint32))


# -- the port's database --------------------------------------------------------

def build_database(corpus: Corpus):
    """The port's Database of the corpus, built through the port's own
    constructors: columns key, date (sorted), country (indexed) and
    pangoLineage (indexed, with the alias table), and per segment and
    partition a ``SegmentIndex`` of ``stored_rows`` over
    ``CsrRowStore.from_coo``. The port picks its own layout from there.
    The least bytes of each alphabet's Mutations query (what the
    ``mutations_roofline_pct`` metric reads, ``roofline_mutations.py``)
    are kept on the database as ``least_mutation_bytes``."""
    from lapis_silo_torch.common.dates import string_to_date
    from lapis_silo_torch.common.symbols import AMINO_ACID, NUCLEOTIDE
    from lapis_silo_torch.config.database_config import (
        DatabaseConfig, DatabaseSchema, Metadata, ValueType,
    )
    from lapis_silo_torch.ops import bitset
    from lapis_silo_torch.storage.columns import (
        DateColumnPartition, Dictionary, IndexedStringColumnPartition,
        PangoLineageColumnPartition, StringColumnPartition,
    )
    from lapis_silo_torch.storage.database import Database, DataVersion
    from lapis_silo_torch.storage.pango_alias import PangoLineageAliasLookup
    from lapis_silo_torch.storage.partition import DatabasePartition
    from lapis_silo_torch.storage.reference_genomes import ReferenceGenomes
    from lapis_silo_torch.storage.rowstore import CsrRowStore
    from lapis_silo_torch.storage.segment import SegmentIndex

    from benchmark.roofline_mutations import query_bytes

    port = {"nuc": NUCLEOTIDE, "aa": AMINO_ACID}
    to_port = {kind: np.array([port[kind].char_to_id[c] for c in chars],
                              dtype=np.int64)
               for kind, chars in ALPHABETS.items()}
    text = {s.name: "".join(s.chars[i] for i in s.reference)
            for s in corpus.segments}
    genomes = ReferenceGenomes(
        {s.name: text[s.name] for s in corpus.segments if s.kind == "nuc"},
        {s.name: text[s.name] for s in corpus.segments if s.kind == "aa"})
    config = DatabaseConfig(schema=DatabaseSchema(
        instance_name="lineage", primary_key="key",
        metadata=[Metadata("key", ValueType.STRING),
                  Metadata(DATE_COLUMN, ValueType.DATE),
                  Metadata("country", ValueType.STRING, generate_index=True),
                  Metadata(LINEAGE_COLUMN, ValueType.PANGOLINEAGE,
                           generate_index=True)],
        date_to_sort_by=DATE_COLUMN, partition_by=LINEAGE_COLUMN))
    alias_key = PangoLineageAliasLookup(corpus.tree.alias_key)
    db = Database(config, alias_key, genomes)
    key_dict, country_dict = Dictionary(), Dictionary()
    unaliased, aliased = Dictionary(), Dictionary()
    key_ids = np.array([key_dict.get_or_create(f"EPI_ISL_{i}")
                        for i in range(corpus.n_rows)], dtype=np.int32)
    country_ids = np.array([country_dict.get_or_create(c)
                            for c in corpus.countries], dtype=np.int32)
    # every lineage of the tree, so that an ancestor without genomes of its
    # own still names its clade
    lineage_ids = np.array([unaliased.get_or_create(u)
                            for u in corpus.tree.unaliased], dtype=np.int32)
    for u in corpus.tree.unaliased:
        aliased.get_or_create(alias_key.alias(u))
    db.dictionaries = {"key": key_dict, "country": country_dict,
                       LINEAGE_COLUMN: (unaliased, aliased)}
    dates = np.array([string_to_date(corpus.date_text(d))
                      for d in range(corpus.n_days)], dtype=np.uint32)
    least = {"nuc": 0, "aa": 0}
    least_lock = threading.Lock()

    def build(p: int):
        lo, hi = int(corpus.bounds[p]), int(corpus.bounds[p + 1])
        n = hi - lo
        partition = DatabasePartition(p, n)
        key_col = StringColumnPartition(key_dict)
        key_col.load_ids(key_ids[lo:hi])
        date_col = DateColumnPartition(is_sorted=True)
        date_col.values = dates[corpus.day[lo:hi]]
        country_col = IndexedStringColumnPartition(country_dict)
        country_col.load_ids(country_ids[corpus.country[lo:hi]])
        lineage_col = PangoLineageColumnPartition(alias_key, unaliased,
                                                  aliased)
        lineage_col.load_ids(lineage_ids[corpus.lineage[lo:hi]])
        partition.columns = {"key": key_col, DATE_COLUMN: date_col,
                             "country": country_col,
                             LINEAGE_COLUMN: lineage_col}
        entries = {"nuc": 0, "aa": 0}
        for segment in corpus.segments:
            rows = stored_rows(corpus, p, segment)
            entries[segment.kind] += len(rows.bits)
            ids = to_port[segment.kind]
            store = CsrRowStore.from_coo(
                bitset.words_for(n), len(rows.positions),
                rows.row.astype(np.int32), rows.word.astype(np.int32),
                rows.bits)
            index = SegmentIndex(
                port[segment.kind], ids[segment.reference].astype(np.uint8),
                n, ids[rows.majority].astype(np.uint8),
                ids[rows.symbols].astype(np.int32),
                rows.positions.astype(np.int32), store)
            target = (partition.nuc_sequences if segment.kind == "nuc"
                      else partition.aa_sequences)
            target[segment.name] = index
        partition.validate()
        with least_lock:
            for kind in least:
                least[kind] += entries[kind]
        return partition

    # NumPy's sorts release the GIL: the partitions build side by side
    with ThreadPoolExecutor(min(corpus.n_partitions,
                                os.cpu_count() or 1)) as pool:
        db.partitions.extend(pool.map(build, range(corpus.n_partitions)))
    db.data_version = DataVersion.mine()
    db.least_mutation_bytes = query_bytes(least, corpus)
    return db


# -- traffic, reference, control -----------------------------------------------

def generator_for(mix: dict, corpus: Corpus, seed: int) -> "LineageGenerator":
    """The generator of the mix's requests over this corpus."""
    return LineageGenerator(mix, corpus, seed)


def reference_for(corpus: Corpus) -> LineageReference:
    """The plain reference that the comparison of ``correct`` reads."""
    return LineageReference(corpus)


def stale_reference_for(corpus: Corpus) -> StaleLineageReference:
    """The control: the reference a release behind."""
    return StaleLineageReference(corpus)


# -- the generator --------------------------------------------------------------

class LineageGenerator:
    """Draws the requests of a Mutations mix (``traffic/mutations.json``)
    over a lineage corpus, in order, from a seed. The kinds alternate
    strictly, request by request. Each filter is ``And(PangoLineage(value,
    includeSublineages), DateBetween(from, to))``: in half of each kind's
    requests the last D days up to the snapshot's newest day, the lineage
    drawn in proportion to its clade's genomes in them; in the other half
    the lineage drawn in proportion to its clade's genomes and a D-day
    window inside the clade's own days. D comes from the mix's
    ``window_days``. A filter that selects no genome or every genome, or a
    request already drawn in the stream or in another stream of the
    generator (the window's and the warm-up's), is drawn again. The
    lineage is written as the metadata holds it, aliased where an alias
    exists."""

    def __init__(self, mix: dict, corpus: Corpus, seed: int):
        self.mix, self.corpus, self.seed = mix, corpus, seed
        self.kinds = mix["kinds"]
        self.filter = mix["filter"]
        tree = corpus.tree
        n_days = corpus.n_days
        # genomes of each clade per day, summed up to each day
        per_day = np.bincount(corpus.lineage.astype(np.int64) * n_days
                              + corpus.day, minlength=len(tree) * n_days
                              ).reshape(len(tree), n_days)
        for i in range(len(tree) - 1, 0, -1):
            if tree.parent[i] >= 0:
                per_day[tree.parent[i]] += per_day[i]
        self.upto = np.zeros((len(tree), n_days + 1), dtype=np.int64)
        np.cumsum(per_day, axis=1, out=self.upto[:, 1:])
        self.clade = self.upto[:, -1]
        days = np.arange(n_days)
        seen = per_day > 0
        self.first = np.where(seen.any(axis=1),
                              np.argmax(seen, axis=1), 0)
        self.last = np.where(seen.any(axis=1),
                             n_days - 1 - np.argmax(seen[:, ::-1], axis=1), 0)
        self.newest = int(days[seen.any(axis=0)].max())
        self.actions = [json.dumps(kind["action"], separators=(",", ":"))
                        for kind in self.kinds]
        self._sent: dict[int, set] = {}
        self._lock = threading.Lock()

    def _in(self, clades, lo: int, hi: int):
        return self.upto[clades, hi + 1] - self.upto[clades, lo]

    def _filter(self, rng, recent: bool) -> tuple[int, int, int]:
        """(lineage, first day, last day) of one filter."""
        windows = self.filter["window_days"]
        n = self.corpus.n_rows
        while True:
            d = int(windows[int(rng.integers(0, len(windows)))])
            if recent:
                lo, hi = max(0, self.newest - d + 1), self.newest
                weights = self._in(slice(None), lo, hi).astype(np.float64)
                lineage = int(rng.choice(len(weights),
                                         p=weights / weights.sum()))
            else:
                weights = self.clade.astype(np.float64)
                lineage = int(rng.choice(len(weights),
                                         p=weights / weights.sum()))
                first, last = int(self.first[lineage]), int(self.last[lineage])
                lo = first + int(rng.integers(0, max(1, last - first - d + 2)))
                hi = min(lo + d - 1, self.corpus.n_days - 1)
            if 0 < int(self._in(lineage, lo, hi)) < n:
                return lineage, lo, hi

    def _body(self, k: int, lineage: int, lo: int, hi: int) -> str:
        f = self.filter
        return (f'{{"action":{self.actions[k]},"filterExpression":'
                f'{{"type":"And","children":[{{"type":"PangoLineage",'
                f'"column":"{f["lineage_column"]}","value":'
                f'"{self.corpus.tree.names[lineage]}","includeSublineages":'
                f'{json.dumps(f["include_sublineages"])}}},'
                f'{{"type":"DateBetween","column":"{f["date_column"]}",'
                f'"from":"{self.corpus.date_text(lo)}",'
                f'"to":"{self.corpus.date_text(hi)}"}}]}}}}')

    def requests(self, n: int, stream: int = 1, part: int = 0) -> list:
        """`n` requests of `stream`; another `part` draws the stream's next
        requests (part k from request k * n on, as ``RequestStream`` asks
        for them), none drawn before in the stream. The kinds go in turn
        by the request's number in the stream."""
        from benchmark.traffic.generator import Request
        first = part * n
        rng = np.random.default_rng([self.seed, stream] if part == 0
                                    else [self.seed, stream, part])
        with self._lock:
            if part == 0:
                self._sent[stream] = set()
            sent = self._sent[stream]
            # nor what another stream (the warm-up's) has drawn
            other = set().union(*(bodies for key, bodies in self._sent.items()
                                  if key != stream))
            out = []
            for i in range(first, first + n):
                k = i % len(self.kinds)
                recent = (i // len(self.kinds)) % 2 == 0
                for _ in range(100000):
                    body = self._body(k, *self._filter(rng, recent))
                    if body not in sent and body not in other:
                        break
                else:
                    raise RuntimeError(f"stream {stream} has drawn every "
                                       f"distinct request of its kind")
                sent.add(body)
                out.append(Request(self.kinds[k]["name"], body))
        return out

    def stream(self, stream: int = 1, chunk: int = 1024):
        """The requests of a closed loop: as many as its clients take, none
        twice (``RequestStream``, drawing `chunk` at a time)."""
        from benchmark.traffic.generator import RequestStream
        return RequestStream(self, stream, chunk)
