"""The benchmark's corpus: SARS-CoV-2-like genomes drawn from a seed.

A frozen copy of the port's synthetic corpus
(``lapis_silo_torch.testing.synthetic_database`` without ``rich``): the same
draws from ``numpy.random.default_rng(seed)`` in the same order, so one seed
gives the same genomes and metadata (``benchmark/tests/test_bench_corpus.py``
holds the two equal). Each genome is the reference plus about
``mutations_per_genome`` point mutations at uniform positions, each to one of
the three other plain nucleotides.

``draw`` yields plain NumPy arrays, which the plain reference reads;
``build_database`` hands them to the port's own constructors.

The module is a corpus module: a configuration names it under its key
``"corpus"``, and the harness calls on it only the five functions of that
contract, ``draw_for``, ``build_database``, ``generator_for``,
``reference_for`` and ``stale_reference_for``
(``benchmark/run.py``'s ``CORPUS_CONTRACT``). A deployment of another
schema brings a module of its own that gives the same five.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from benchmark.reference.control import StaleReference
from benchmark.reference.silo import Reference
from benchmark.traffic.generator import Generator

COUNTRIES = ["Switzerland", "Germany", "France", "Italy", "Austria", "Spain"]
YEAR, MONTH = 2021, 3  # every sequence was collected on day 1..27 of it
N_DAYS = 27


@dataclass
class Partition:
    n_rows: int
    row_base: int  # global row of the partition's first sequence
    days: np.ndarray  # int64 [n_rows] day of the month, ascending
    country: np.ndarray  # int64 [n_rows] index into COUNTRIES
    age: np.ndarray  # int64 [n_rows]
    # one entry per mutation, ascending by (row, position)
    rows: np.ndarray  # int64 local row
    positions: np.ndarray  # int64, 0-based
    symbols: np.ndarray  # int64 symbol id 1..4, never the reference's
    # the entries' order by (position, symbol, row)
    by_position: np.ndarray


@dataclass
class Corpus:
    reference: np.ndarray  # uint8 [length] symbol ids 1..4
    partitions: list[Partition]

    @property
    def length(self) -> int:
        return len(self.reference)

    @property
    def n_rows(self) -> int:
        return sum(p.n_rows for p in self.partitions)


def partition_sizes(n_rows: int, n_partitions: int) -> list[int]:
    return [n_rows // n_partitions + (1 if i < n_rows % n_partitions else 0)
            for i in range(n_partitions)]


def draw(n_rows: int, length: int, n_partitions: int,
         mutations_per_genome: int, seed: int) -> Corpus:
    rng = np.random.default_rng(seed)
    reference = rng.integers(1, 5, size=length).astype(np.uint8)
    partitions = []
    row_base = 0
    for part_rows in partition_sizes(n_rows, n_partitions):
        days = np.sort(rng.integers(1, N_DAYS + 1, size=part_rows))
        country = rng.integers(0, len(COUNTRIES), size=part_rows)
        age = rng.integers(1, 99, size=part_rows)
        n_mut = part_rows * mutations_per_genome
        rows = rng.integers(0, part_rows, size=n_mut)
        positions = rng.integers(0, length, size=n_mut)
        # one symbol per (row, position): duplicates drawn twice count once
        # (np.unique's result, by a sort: some NumPy versions hash instead,
        # many times slower on this many distinct values)
        flat = np.sort(rows * length + positions)
        flat = flat[np.concatenate(([True], flat[1:] != flat[:-1]))]
        rows, positions = np.divmod(flat, length)
        shift = rng.integers(1, 4, size=len(rows))
        symbols = (reference[positions] - 1 + shift) % 4 + 1
        # two stable radix passes over the (row, position)-ordered entries
        order = np.argsort(symbols.astype(np.uint8), kind="stable")
        order = order[np.argsort(positions[order].astype(np.uint16),
                                 kind="stable")]
        partitions.append(Partition(part_rows, row_base, days, country, age,
                                    rows, positions, symbols, order))
        row_base += part_rows
    return Corpus(reference, partitions)


def draw_for(config: dict, seed: int) -> Corpus:
    """The configuration's corpus, drawn from the seed."""
    return draw(config["n_sequences"], config["sequence_length"],
                config["n_partitions"], config["mutations_per_genome"], seed)


def generator_for(mix: dict, corpus: Corpus, seed: int) -> Generator:
    """The generator of the mix's requests over this corpus' genome and
    metadata."""
    return Generator(mix, corpus.reference, COUNTRIES, YEAR, MONTH, N_DAYS,
                     seed)


def reference_for(corpus: Corpus) -> Reference:
    """The plain reference that the comparison of ``correct`` reads."""
    return Reference(corpus, COUNTRIES, YEAR, MONTH)


def stale_reference_for(corpus: Corpus) -> StaleReference:
    """The control: the reference a release behind."""
    return StaleReference(corpus, COUNTRIES, YEAR, MONTH)


def build_database(corpus: Corpus):
    """The port's Database of the corpus, built through the port's own
    constructors: columns key, date (sorted), country (indexed) and age,
    and the nucleotide sequence ``main`` with the reference implicit and
    every mutated (symbol, position) a stored row of its sequences, handed
    to ``CsrRowStore.from_coo`` as (row, word, bits) triples in the drawn
    order. The port picks its own layout from there: ``SegmentIndex``
    orders the rows, ``from_coo`` sorts and merges the words, and the
    device engine decides what goes to its dense bank."""
    from lapis_silo_torch.common.symbols import NUCLEOTIDE
    from lapis_silo_torch.config.database_config import (
        DatabaseConfig, DatabaseSchema, Metadata, ValueType,
    )
    from lapis_silo_torch.ops import bitset
    from lapis_silo_torch.storage.columns import (
        DateColumnPartition, Dictionary, IndexedStringColumnPartition,
        IntColumnPartition, StringColumnPartition,
    )
    from lapis_silo_torch.storage.database import Database, DataVersion
    from lapis_silo_torch.storage.pango_alias import PangoLineageAliasLookup
    from lapis_silo_torch.storage.partition import DatabasePartition
    from lapis_silo_torch.storage.reference_genomes import ReferenceGenomes
    from lapis_silo_torch.storage.rowstore import CsrRowStore
    from lapis_silo_torch.storage.segment import SegmentIndex

    reference = corpus.reference
    length = corpus.length
    genomes = ReferenceGenomes(
        {"main": "".join(NUCLEOTIDE.chars[i] for i in reference)}, {})
    config = DatabaseConfig(schema=DatabaseSchema(
        instance_name="synthetic", primary_key="key",
        metadata=[Metadata("key", ValueType.STRING),
                  Metadata("date", ValueType.DATE),
                  Metadata("country", ValueType.STRING, generate_index=True),
                  Metadata("age", ValueType.INT)],
        date_to_sort_by="date"))
    db = Database(config, PangoLineageAliasLookup(), genomes)
    key_dict, country_dict = Dictionary(), Dictionary()
    key_ids = np.array([key_dict.get_or_create(f"SEQ_{i}")
                        for i in range(corpus.n_rows)], dtype=np.int32)
    country_ids = np.array([country_dict.get_or_create(c)
                            for c in COUNTRIES], dtype=np.int32)
    db.dictionaries = {"key": key_dict, "country": country_dict}

    def build(pid: int, part: Partition):
        n = part.n_rows
        partition = DatabasePartition(pid, n)
        key_col = StringColumnPartition(key_dict)
        key_col.load_ids(key_ids[part.row_base:part.row_base + n])
        date_col = DateColumnPartition(is_sorted=True)
        date_col.values = ((YEAR << 16) + (MONTH << 12)
                           + part.days).astype(np.uint32)
        country_col = IndexedStringColumnPartition(country_dict)
        country_col.load_ids(country_ids[part.country])
        age_col = IntColumnPartition()
        age_col.values = part.age.astype(np.int32)
        partition.columns = {"key": key_col, "date": date_col,
                             "country": country_col, "age": age_col}

        # the mutated (symbol, position) pairs, numbered by position and
        # symbol; each entry one bit of its pair's row
        pair_key = part.positions * 4 + (part.symbols - 1)
        present = np.bincount(pair_key, minlength=4 * length) > 0
        pair_of_key = np.cumsum(present) - 1
        pairs = np.flatnonzero(present)
        rows = part.rows
        store = CsrRowStore.from_coo(
            bitset.words_for(n), len(pairs),
            pair_of_key[pair_key].astype(np.int32),
            (rows >> 5).astype(np.int32),
            np.uint32(1) << (rows & 31).astype(np.uint32))
        partition.nuc_sequences["main"] = SegmentIndex(
            NUCLEOTIDE, reference, n, reference,
            (pairs % 4 + 1).astype(np.int32), (pairs // 4).astype(np.int32),
            store)
        partition.validate()
        return partition

    # NumPy's sorts release the GIL: the partitions build side by side
    with ThreadPoolExecutor(min(len(corpus.partitions),
                                os.cpu_count() or 1)) as pool:
        db.partitions.extend(pool.map(build, range(len(corpus.partitions)),
                                      corpus.partitions))
    db.data_version = DataVersion.mine()
    return db
