"""Synthetic corpora for benchmarks, tests and the smoke run on the card:
`synthetic_database` builds a Database directly (no input files needed),
`write_ingest_inputs` writes seeded input files for the ingest.

Genomes are the reference sequence plus ~`mutations_per_genome` random point
mutations, which reproduces the real workload's structure: the reference-
symbol plane is dense, mutation planes are sparse."""

from __future__ import annotations

import os

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


# -- ingest inputs -----------------------------------------------------------

# pango lineages and their shares: with partitionBy on this column, the
# partitioner's greedy merge (partitions of about a 32nd of the rows) puts
# the rare keys in with the next frequent one, so the inputs ingest into 4
# partitions: [null, A.1, AY.4], [AY.4.2, B.1.1.7], [B.1.617.2], [BA.2]
INGEST_LINEAGES = ((None, 0.01), ("A.1", 0.01), ("AY.4", 0.24),
                   ("AY.4.2", 0.01), ("B.1.1.7", 0.24), ("B.1.617.2", 0.24),
                   ("BA.2", 0.25))
PANGO_ALIASES = {"AY": "B.1.617.2", "BA": "B.1.1.529"}
INGEST_SCHEMA = {"schema": {
    "instanceName": "ingest",
    "primaryKey": "key",
    "dateToSortBy": "date",
    "partitionBy": "pango_lineage",
    "metadata": [
        {"name": "key", "type": "string"},
        {"name": "date", "type": "date"},
        {"name": "country", "type": "string", "generateIndex": True},
        {"name": "age", "type": "int"},
        {"name": "qc_value", "type": "float"},
        # the schema has no boolean type: JSON booleans ingest as the
        # strings "true" and "false"
        {"name": "is_reinfection", "type": "string"},
        {"name": "pango_lineage", "type": "pango_lineage"},
        {"name": "nucleotideInsertions", "type": "insertion"},
        {"name": "aminoAcidInsertions", "type": "aaInsertion"},
    ]}}
_BATCH = 1024


class IngestInputs:
    """What `write_ingest_inputs` wrote, and the arrays it drew them from
    (row i is the i-th record of the input files): enough to compute
    answers without the engine."""

    def __init__(self, directory, reference_ids, metadata, null_sequence,
                 mutations):
        self.directory = str(directory)
        self.preprocessing_config = os.path.join(
            self.directory, "preprocessing_config.yaml")
        self.database_config = os.path.join(self.directory,
                                            "database_config.yaml")
        self.reference_ids = reference_ids
        self.metadata = metadata
        self.null_sequence = null_sequence
        # nucleotide point mutations: (row, 0-based position, symbol id)
        self.mut_rows, self.mut_pos, self.mut_sym = mutations

    @property
    def n_rows(self) -> int:
        return len(self.null_sequence)

    def country_counts(self) -> dict:
        """{country or None: number of records}."""
        values, counts = np.unique(self.metadata["country"],
                                   return_counts=True)
        return {(COUNTRIES[v] if v >= 0 else None): int(c)
                for v, c in zip(values, counts)}

    def nucleotide_count(self, position: int, symbol: str) -> int:
        """Records whose "main" sequence holds `symbol` at the 1-based
        `position` (null sequences hold none)."""
        pos = position - 1
        sid = NUCLEOTIDE.char_to_id[symbol]
        live = ~self.null_sequence
        at = self.mut_pos == pos
        rows, syms = self.mut_rows[at], self.mut_sym[at]
        mutated = live[rows]
        if sid == self.reference_ids[pos]:
            return int(live.sum() - mutated.sum())
        return int(((syms == sid) & mutated).sum())


def _mutate(rng, reference_ids, n, per_genome, n_plain):
    """[n, L] symbol ids: the reference plus about `per_genome` point
    mutations per row to another of the first `n_plain` non-gap symbols."""
    length = len(reference_ids)
    seqs = np.broadcast_to(reference_ids, (n, length)).copy()
    pos = rng.integers(0, length, size=(n, per_genome))
    shift = rng.integers(1, n_plain, size=(n, per_genome))
    seqs[np.arange(n)[:, None], pos] = (
        (reference_ids[pos].astype(np.int64) - 1 + shift) % n_plain + 1)
    return seqs


def _insertions(rng, n, p, max_count, chars, max_pos, max_len):
    """Per row a list of "<pos>:<symbols>" insertions (empty with
    probability 1 - p)."""
    out = []
    for row in range(n):
        if rng.random() >= p:
            out.append([])
            continue
        entries = []
        for _ in range(int(rng.integers(1, max_count + 1))):
            size = int(rng.integers(1, max_len + 1))
            symbols = "".join(chars[i] for i in rng.integers(0, len(chars),
                                                              size=size))
            entries.append(f"{int(rng.integers(1, max_pos + 1))}:{symbols}")
        out.append(entries)
    return out


def write_ingest_inputs(directory, n_rows: int = 2048, length: int = 29903,
                        *, fmt: str = "ndjson", compression: str | None = None,
                        seed: int = 0, gene_length: int = 1273,
                        p_unaligned: float = 1 / 16,
                        intermediate_directory=None,
                        output_directory=None) -> IngestInputs:
    """Seeded ingest inputs under `directory`: the records as NDJSON
    (``fmt="ndjson"``) or as metadata.tsv plus FASTA files (``fmt="tsv"``),
    with reference_genomes.json, a pango alias file, database_config.yaml
    and preprocessing_config.yaml. `compression` ("zst" or "xz") compresses
    the NDJSON or the FASTA files.

    Each record has a "main" nucleotide sequence of `length` positions (the
    random reference plus 30 point mutations, as `synthetic_database` draws
    them), a gene "S" of `gene_length` amino acids (3 point mutations), with
    probability `p_unaligned` an unaligned sequence (the aligned one, its
    ends trimmed), nucleotide and amino-acid insertions, and metadata of
    every column type with nulls; 1 record in 256 (at least 2) has null
    sequences.
    `partitionBy` and `dateToSortBy` are set (INGEST_SCHEMA)."""
    import datetime
    import json
    import lzma

    import yaml

    from .common import zstd

    directory = os.path.abspath(str(directory))
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    reference_ids = rng.integers(1, 5, size=length).astype(np.uint8)
    gene_ids = rng.integers(1, 21, size=gene_length).astype(np.uint8)
    nuc_chars = np.frombuffer("".join(NUCLEOTIDE.chars).encode(), np.uint8)
    aa_chars = np.frombuffer("".join(AMINO_ACID.chars).encode(), np.uint8)
    reference = nuc_chars[reference_ids].tobytes().decode()
    gene = aa_chars[gene_ids].tobytes().decode()

    # metadata; -1 (or NaN) marks a null
    lineage_p = np.array([p for _, p in INGEST_LINEAGES])
    metadata = {
        "day": np.where(rng.random(n_rows) < 0.05, -1,
                        rng.integers(0, 365, size=n_rows)),
        "country": np.where(rng.random(n_rows) < 0.05, -1,
                            rng.integers(0, len(COUNTRIES), size=n_rows)),
        "age": np.where(rng.random(n_rows) < 0.05, -1,
                        rng.integers(0, 100, size=n_rows)),
        "qc_value": np.where(rng.random(n_rows) < 0.1, np.nan,
                             np.round(rng.random(n_rows), 3)),
        "is_reinfection": np.where(rng.random(n_rows) < 0.2, -1,
                                   rng.integers(0, 2, size=n_rows)),
        "lineage": rng.choice(len(INGEST_LINEAGES), size=n_rows,
                              p=lineage_p / lineage_p.sum()),
    }
    nuc_ins = _insertions(rng, n_rows, 0.25, 2, "ACGT", length, 8)
    aa_ins = _insertions(rng, n_rows, 0.2, 1, "ACDEFGHIKLMNPQRSTVWY",
                         gene_length, 6)
    null_sequence = rng.random(n_rows) < 1 / 256
    null_sequence[[1, n_rows // 2]] = True
    has_unaligned = (rng.random(n_rows) < p_unaligned) & ~null_sequence
    trims = rng.integers(0, 51, size=(n_rows, 2))
    keys = [f"SEQ_{i:07d}" for i in range(n_rows)]
    start = datetime.date(2021, 1, 1)

    def meta(i):
        day, country, age = (int(metadata[f][i])
                             for f in ("day", "country", "age"))
        qc, reinfection = metadata["qc_value"][i], int(
            metadata["is_reinfection"][i])
        return {
            "key": keys[i],
            "date": (str(start + datetime.timedelta(days=day))
                     if day >= 0 else None),
            "country": COUNTRIES[country] if country >= 0 else None,
            "age": age if age >= 0 else None,
            "qc_value": None if np.isnan(qc) else float(qc),
            "is_reinfection": None if reinfection < 0 else bool(reinfection),
            "pango_lineage": INGEST_LINEAGES[int(metadata["lineage"][i])][0],
        }

    def opener(path):
        if compression == "zst":
            return _ZstdWriter(path + ".zst", zstd)
        if compression == "xz":
            return lzma.open(path + ".xz", "wb")
        if compression is not None:
            raise ValueError(f"unknown compression {compression!r}")
        return open(path, "wb", buffering=1 << 22)

    if fmt == "ndjson":
        outputs = {"ndjson": opener(os.path.join(directory,
                                                 "input_file.ndjson"))}
    elif fmt == "tsv":
        outputs = {name: opener(os.path.join(directory, name + ".fasta"))
                   for name in ("nuc_main", "gene_S", "unaligned_main")}
        outputs["tsv"] = open(os.path.join(directory, "metadata.tsv"), "wb")
        outputs["tsv"].write(("\t".join(
            m["name"] for m in INGEST_SCHEMA["schema"]["metadata"])
            + "\n").encode())
    else:
        raise ValueError(f"unknown input format {fmt!r}")

    mutations = []
    try:
        for base in range(0, n_rows, _BATCH):
            n = min(_BATCH, n_rows - base)
            seqs = _mutate(rng, reference_ids, n, 30, 4)
            genes = _mutate(rng, gene_ids, n, 3, 20)
            rows, pos = np.nonzero(seqs != reference_ids)
            mutations.append((rows + base, pos, seqs[rows, pos]))
            seq_text, gene_text = nuc_chars[seqs], aa_chars[genes]
            for j in range(n):
                i = base + j
                null = bool(null_sequence[i])
                aligned = None if null else seq_text[j].tobytes()
                aa = None if null else gene_text[j].tobytes()
                unaligned = (aligned[trims[i, 0]: length - trims[i, 1]]
                             if has_unaligned[i] else None)
                if fmt == "ndjson":
                    outputs["ndjson"].write(_ndjson_line(
                        meta(i), aligned, aa, unaligned, nuc_ins[i],
                        aa_ins[i], json))
                    continue
                row = meta(i)
                row["nucleotideInsertions"] = ",".join(
                    f"main:{e}" for e in nuc_ins[i])
                row["aminoAcidInsertions"] = ",".join(
                    f"S:{e}" for e in aa_ins[i])
                outputs["tsv"].write(("\t".join(
                    _tsv_value(row[m["name"]])
                    for m in INGEST_SCHEMA["schema"]["metadata"])
                    + "\n").encode())
                header = f">{keys[i]}\n".encode()
                for name, text in (("nuc_main", aligned), ("gene_S", aa),
                                   ("unaligned_main", unaligned)):
                    if text is not None:
                        outputs[name].write(header + text + b"\n")
    finally:
        for out in outputs.values():
            out.close()

    with open(os.path.join(directory, "reference_genomes.json"), "w") as f:
        json.dump({"nucleotideSequences": [{"name": "main",
                                            "sequence": reference}],
                   "genes": [{"name": "S", "sequence": gene}]}, f)
    with open(os.path.join(directory, "pango_alias.json"), "w") as f:
        json.dump(PANGO_ALIASES, f)
    with open(os.path.join(directory, "database_config.yaml"), "w") as f:
        yaml.safe_dump(INGEST_SCHEMA, f, sort_keys=False)
    pcfg = {
        "inputDirectory": directory,
        "outputDirectory": str(output_directory
                               or os.path.join(directory, "output")),
        "intermediateResultsDirectory": str(
            intermediate_directory or os.path.join(directory, "temp")),
        "pangoLineageDefinitionFilename": "pango_alias.json",
    }
    if fmt == "ndjson":
        pcfg["ndjsonInputFilename"] = "input_file.ndjson"
    with open(os.path.join(directory, "preprocessing_config.yaml"), "w") as f:
        yaml.safe_dump(pcfg, f, sort_keys=False)
    return IngestInputs(directory, reference_ids, metadata, null_sequence,
                        tuple(np.concatenate(parts) for parts in
                              zip(*mutations)))


def _ndjson_line(meta, aligned, aa, unaligned, nuc_ins, aa_ins, json) -> bytes:
    """One NDJSON record; sequences are ASCII bytes or None (null)."""
    def seq(name, text):
        return (b'{"' + name.encode() + b'":'
                + (b"null" if text is None else b'"' + text + b'"') + b"}")

    return (b'{"metadata":' + json.dumps(meta).encode()
            + b',"alignedNucleotideSequences":' + seq("main", aligned)
            + b',"alignedAminoAcidSequences":' + seq("S", aa)
            + b',"unalignedNucleotideSequences":' + seq("main", unaligned)
            + b',"nucleotideInsertions":' + json.dumps(
                {"main": nuc_ins}).encode()
            + b',"aminoAcidInsertions":' + json.dumps({"S": aa_ins}).encode()
            + b"}\n")


def _tsv_value(value) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return "true" if value else "false"
    return str(value)


class _ZstdWriter:
    """A .zst file written as one frame per 16 MiB of input (zstd streams
    are concatenations of frames)."""

    def __init__(self, path, zstd):
        self._file = open(path, "wb")
        self._zstd = zstd
        self._pending = []
        self._size = 0

    def write(self, data: bytes):
        self._pending.append(data)
        self._size += len(data)
        if self._size >= 16 << 20:
            self._flush()

    def _flush(self):
        if self._pending:
            self._file.write(self._zstd.compress(b"".join(self._pending)))
        self._pending, self._size = [], 0

    def close(self):
        self._flush()
        self._file.close()
