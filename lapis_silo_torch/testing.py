"""Synthetic corpus generation for benchmarks, tests and the smoke run on
the card — builds a Database directly (no input files needed).

Genomes are the reference sequence plus ~`mutations_per_genome` random point
mutations, which reproduces the real workload's structure: the reference-
symbol plane is dense, mutation planes are sparse."""

from __future__ import annotations

import numpy as np

from .common.symbols import AMINO_ACID, NUCLEOTIDE
from .config.database_config import DatabaseConfig, DatabaseSchema, Metadata, ValueType
from .ops import bitset
from .storage.columns import (
    DateColumnPartition,
    Dictionary,
    FloatColumnPartition,
    IndexedStringColumnPartition,
    InsertionColumnPartition,
    IntColumnPartition,
    PangoLineageColumnPartition,
    StringColumnPartition,
)
from .storage.database import Database, DataVersion
from .storage.pango_alias import PangoLineageAliasLookup
from .storage.partition import DatabasePartition
from .storage.reference_genomes import ReferenceGenomes
from .storage.rowstore import CSR_MIN_WORDS, CsrRowStore
from .storage.segment import SegmentIndex

COUNTRIES = ["Switzerland", "Germany", "France", "Italy", "Austria", "Spain"]
LINEAGES = ["A", "B.1", "B.1.1", "B.1.1.7", "B.1.617.2", "AY.4", "AY.4.2", ""]


def _random_segment(alphabet, reference_ids, part_rows, mutations_per_genome,
                    rng, n_plain_symbols):
    """Compact SegmentIndex with random point mutations over the reference
    (symbols drawn from the first n_plain_symbols non-gap entries)."""
    length = len(reference_ids)
    n_words = bitset.words_for(part_rows)
    n_mut = part_rows * mutations_per_genome
    rows = rng.integers(0, part_rows, size=n_mut).astype(np.int64)
    positions = rng.integers(0, length, size=n_mut).astype(np.int64)
    # dedupe (row, pos) so each row has exactly one symbol per position
    flat = rows * length + positions
    flat, unique_idx = np.unique(flat, return_index=True)
    rows, positions = rows[unique_idx], positions[unique_idx]
    # mutate to a symbol != reference: rotate within the plain symbols
    shift = rng.integers(1, n_plain_symbols, size=len(rows)).astype(np.int64)
    syms = ((reference_ids[positions] - 1 + shift) % n_plain_symbols + 1)
    # group mutations by (symbol, position) -> one stored row each; the
    # reference symbol stays implicit (majority), so memory is compact
    # from the start (no dense [S, L, W] tensor is ever allocated)
    pair = syms * length + positions
    unique_pairs, pair_idx = np.unique(pair, return_inverse=True)
    sym_ids = (unique_pairs // length).astype(np.int32)
    pos_ids = (unique_pairs % length).astype(np.int32)
    counts = np.bincount(pair_idx, minlength=len(unique_pairs)).astype(np.int64)
    if n_words >= CSR_MIN_WORDS:
        # build CSR directly (the dense per-pair rows would be ~100x
        # bigger at multi-million-sequence scale)
        store = CsrRowStore.from_coo(
            n_words, len(unique_pairs), pair_idx.astype(np.int32),
            (rows >> 5).astype(np.int32),
            (np.uint32(1) << (rows & 31).astype(np.uint32)),
        )
    else:
        stored = np.zeros((len(unique_pairs), n_words), dtype=np.uint32)
        flat_idx = pair_idx * n_words + (rows >> 5)
        np.bitwise_or.at(
            stored.reshape(-1), flat_idx,
            np.uint32(1) << (rows & 31).astype(np.uint32),
        )
        store = stored
    return SegmentIndex(alphabet, reference_ids, part_rows, reference_ids,
                        sym_ids, pos_ids, store, counts=counts)


def synthetic_database(
    n_rows: int = 4096,
    length: int = 1024,
    n_partitions: int = 4,
    mutations_per_genome: int = 30,
    seed: int = 0,
    rich: bool = False,
) -> Database:
    """rich=True adds the full column/segment zoo — an amino-acid segment
    ("geneE"), a pango-lineage column, a float column, and nuc + AA
    insertion columns — so fuzz/parity harnesses can reach every one of
    the 21 query-expression types. Default off: the benchmark corpora stay
    lean and bit-identical to round-1 numbers."""
    rng = np.random.default_rng(seed)
    reference_ids = rng.integers(1, 5, size=length).astype(np.uint8)  # A/C/G/T
    reference_str = "".join(NUCLEOTIDE.chars[i] for i in reference_ids)
    aa_length = max(16, length // 4)
    if rich:
        # rich-only draws stay OFF the shared stream for lean corpora:
        # consuming them unconditionally would shift every later draw and
        # silently change the benchmark corpora round-1 numbers (and
        # bench.py's vs_baseline) were measured on
        aa_reference_ids = rng.integers(1, 21, size=aa_length).astype(np.uint8)
        aa_reference_str = "".join(AMINO_ACID.chars[i] for i in aa_reference_ids)
        genomes = ReferenceGenomes({"main": reference_str},
                                   {"geneE": aa_reference_str})
    else:
        aa_reference_ids = None
        genomes = ReferenceGenomes({"main": reference_str}, {})

    metadata = [
        Metadata("key", ValueType.STRING),
        Metadata("date", ValueType.DATE),
        Metadata("country", ValueType.STRING, generate_index=True),
        Metadata("age", ValueType.INT),
    ]
    if rich:
        metadata += [
            Metadata("pango_lineage", ValueType.PANGOLINEAGE,
                     generate_index=True),
            Metadata("qc_value", ValueType.FLOAT),
            Metadata("nucleotideInsertions", ValueType.NUC_INSERTION),
            Metadata("aminoAcidInsertions", ValueType.AA_INSERTION),
        ]
    config = DatabaseConfig(
        schema=DatabaseSchema(
            instance_name="synthetic",
            primary_key="key",
            metadata=metadata,
            date_to_sort_by="date",
        )
    )
    alias_key = PangoLineageAliasLookup()
    db = Database(config, alias_key, genomes)
    key_dict = Dictionary()
    country_dict = Dictionary()
    db.dictionaries = {"key": key_dict, "country": country_dict}
    if rich:
        pango_dicts = (Dictionary(), Dictionary())
        nuc_ins_dict = Dictionary()
        aa_ins_dict = Dictionary()
        db.dictionaries.update({
            "pango_lineage": pango_dicts,
            "nucleotideInsertions": nuc_ins_dict,
            "aminoAcidInsertions": aa_ins_dict,
        })

    rows_per_partition = [
        n_rows // n_partitions + (1 if i < n_rows % n_partitions else 0)
        for i in range(n_partitions)
    ]
    row_base = 0
    for pid, part_rows in enumerate(rows_per_partition):
        partition = DatabasePartition(pid, part_rows)
        n_words = bitset.words_for(part_rows)

        # --- metadata columns (vectorized; million-row corpora skip the
        # per-row dictionary path: unique keys only matter to small tests) ---
        key_col = StringColumnPartition(key_dict)
        if part_rows < (1 << 20):
            key_col._ids = [
                key_dict.get_or_create(f"SEQ_{row_base + i}") for i in range(part_rows)
            ]
            key_col.finalize()
        else:
            key_col.ids = np.full(
                part_rows, key_dict.get_or_create("SEQ"), dtype=np.int32
            )
        date_col = DateColumnPartition(is_sorted=True)
        days = np.sort(rng.integers(1, 28, size=part_rows))
        date_col.values = ((2021 << 16) + (3 << 12) + days).astype(np.uint32)
        country_col = IndexedStringColumnPartition(country_dict)
        country_vids = np.array(
            [country_dict.get_or_create(c) for c in COUNTRIES], dtype=np.int32
        )
        country_col.ids = country_vids[
            rng.integers(0, len(COUNTRIES), size=part_rows)
        ].astype(np.int32)
        country_col._n_rows = part_rows
        for vid in np.unique(country_col.ids):
            country_col.value_bitmaps[int(vid)] = bitset.pack_bool(
                country_col.ids == vid
            )
        age_col = IntColumnPartition()
        age_col.values = rng.integers(1, 99, size=part_rows).astype(np.int32)
        partition.columns = {
            "key": key_col, "date": date_col, "country": country_col, "age": age_col,
        }
        if rich:
            pango_col = PangoLineageColumnPartition(alias_key, *pango_dicts)
            for lineage_idx in rng.integers(0, len(LINEAGES), size=part_rows):
                pango_col.insert(LINEAGES[int(lineage_idx)])
            pango_col.finalize()
            qc_col = FloatColumnPartition()
            qc = rng.random(part_rows) * 100.0
            qc[rng.random(part_rows) < 0.1] = np.nan  # nulls
            qc_col.values = qc
            nuc_ins_col = InsertionColumnPartition(
                nuc_ins_dict, "main", NUCLEOTIDE, "nuc_insertion")
            aa_ins_col = InsertionColumnPartition(
                aa_ins_dict, None, AMINO_ACID, "aa_insertion")
            nuc_chars = "ACGT"
            aa_chars = "ACDEFGHIKLMNPQRSTVWY"
            for _ in range(part_rows):
                if rng.random() < 0.25:
                    n_ins = 1 + int(rng.random() < 0.2)
                    parts = []
                    for _ in range(n_ins):
                        ins = "".join(nuc_chars[i] for i in
                                      rng.integers(0, 4, size=rng.integers(1, 9)))
                        parts.append(f"{int(rng.integers(1, length))}:{ins}")
                    nuc_ins_col.insert(",".join(parts))
                else:
                    nuc_ins_col.insert_null()
                if rng.random() < 0.2:
                    ins = "".join(aa_chars[i] for i in
                                  rng.integers(0, 20, size=rng.integers(1, 7)))
                    aa_ins_col.insert(f"geneE:{int(rng.integers(1, aa_length))}:{ins}")
                else:
                    aa_ins_col.insert_null()
            nuc_ins_col.finalize()
            aa_ins_col.finalize()
            partition.columns.update({
                "pango_lineage": pango_col, "qc_value": qc_col,
                "nucleotideInsertions": nuc_ins_col,
                "aminoAcidInsertions": aa_ins_col,
            })

        # --- compact bitplanes: reference implicit, mutations stored ---
        partition.nuc_sequences["main"] = _random_segment(
            NUCLEOTIDE, reference_ids, part_rows, mutations_per_genome, rng, 4)
        if rich:
            partition.aa_sequences["geneE"] = _random_segment(
                AMINO_ACID, aa_reference_ids, part_rows,
                max(2, mutations_per_genome // 4), rng, 20)
        partition.validate()
        db.partitions.append(partition)
        row_base += part_rows

    db.data_version = DataVersion.mine()
    return db


def sample_count_queries(db: Database, n_queries: int = 32, seed: int = 1) -> list[str]:
    """Mutation-filter count queries matching the BASELINE metric: boolean
    combinations of NucleotideEquals / HasNucleotideMutation leaves."""
    import json

    rng = np.random.default_rng(seed)
    ref = db.reference_genomes.nucleotide_ids["main"]
    length = len(ref)
    queries = []
    for qi in range(n_queries):
        def leaf():
            pos = int(rng.integers(0, length))
            if rng.random() < 0.5:
                ref_sym = int(ref[pos])
                sym = NUCLEOTIDE.chars[(ref_sym % 4) + 1]
                return {"type": "NucleotideEquals", "position": pos + 1, "symbol": sym}
            return {"type": "HasNucleotideMutation", "position": pos + 1}

        kind = qi % 4
        if kind == 0:
            filt = leaf()
        elif kind == 1:
            filt = {"type": "And", "children": [leaf(), leaf()]}
        elif kind == 2:
            filt = {"type": "Or", "children": [leaf(), {"type": "Not", "child": leaf()}]}
        else:
            filt = {
                "type": "N-Of", "numberOfMatchers": 2, "matchExactly": False,
                "children": [leaf(), leaf(), leaf()],
            }
        queries.append(json.dumps({"action": {"type": "Aggregated"},
                                   "filterExpression": filt}))
    return queries


def hot_count_queries(db: Database, positions, n_queries: int,
                      seed: int) -> list[str]:
    """Fresh random boolean combinations over a FIXED (position, symbol)
    working set — the serving norm (dashboards repeat the same mutations):
    distinct programs per batch, bounded leaf universe. Shared by
    scripts/pool_bench.py and bench.py's two-tier probe."""
    import json

    rng = np.random.default_rng(seed)
    ref = db.reference_genomes.nucleotide_ids["main"]
    out = []
    for qi in range(n_queries):
        def leaf():
            pos = int(positions[rng.integers(0, len(positions))])
            ref_sym = int(ref[pos])
            if rng.random() < 0.5:
                sym = NUCLEOTIDE.chars[(ref_sym % 4) + 1]
                return {"type": "NucleotideEquals", "position": pos + 1,
                        "symbol": sym}
            return {"type": "HasNucleotideMutation", "position": pos + 1}

        kind = qi % 4
        if kind == 0:
            filt = {"type": "And", "children": [leaf(), leaf()]}
        elif kind == 1:
            filt = {"type": "Or", "children": [
                leaf(), {"type": "Not", "child": leaf()}]}
        elif kind == 2:
            filt = {"type": "N-Of", "numberOfMatchers": 2,
                    "matchExactly": False,
                    "children": [leaf(), leaf(), leaf()]}
        else:
            filt = {"type": "And", "children": [
                leaf(), {"type": "Or", "children": [leaf(), leaf()]}]}
        out.append(json.dumps({"action": {"type": "Aggregated"},
                               "filterExpression": filt}))
    return out
