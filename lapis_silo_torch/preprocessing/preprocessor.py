"""The ingest pipeline: metadata + FASTA/NDJSON -> Database.

Parity with reference src/silo/preprocessing/preprocessor.cpp, redesigned
host-side (no DuckDB): the metadata table is a list of row dicts, the
partitioner is partitioner.py, and sequence ingestion packs genomes directly
into dense bitplanes (storage/segment.py) in row-block batches.

Row order within a partition is ORDER BY (dateToSortBy NULLS FIRST,
primaryKey) — reference database_config.cpp:190-198 + DuckDB 0.8 null
ordering — which the sorted-date range filters depend on.
"""

from __future__ import annotations

import logging
import os
import time

from ..common.dates import string_to_date
from ..common.symbols import AMINO_ACID, NUCLEOTIDE
from ..config.database_config import ColumnType, DatabaseConfig
from ..storage.columns import (
    DateColumnPartition,
    Dictionary,
    FloatColumnPartition,
    IndexedStringColumnPartition,
    InsertionColumnPartition,
    IntColumnPartition,
    PangoLineageColumnPartition,
    StringColumnPartition,
)
from ..storage.database import Database, DataVersion
from ..storage.pango_alias import PangoLineageAliasLookup
from ..storage.partition import DatabasePartition
from ..storage.reference_genomes import ReferenceGenomes
from ..storage.segment import SegmentIndexBuilder
from ..storage.unaligned import UnalignedPartitionStore
from . import readers
from .partitioner import partition_keys, sort_key_nulls_first
from .preprocessing_config import PreprocessingConfig
from .spool import SequenceSpool
from .table import MetadataTable

logger = logging.getLogger(__name__)

SEQUENCE_BATCH = 1024


class PreprocessingError(Exception):
    pass


class Preprocessor:
    def __init__(self, preprocessing_config: PreprocessingConfig, database_config: DatabaseConfig):
        self.pcfg = preprocessing_config
        self.config = database_config

    def preprocess(self) -> Database:
        import contextlib
        import os
        import tempfile

        t0 = time.time()
        pango_path = self.pcfg.pango_lineage_definition_path()
        alias_key = (
            PangoLineageAliasLookup.read_from_file(pango_path)
            if pango_path
            else PangoLineageAliasLookup()
        )
        reference_genomes = ReferenceGenomes.read_from_file(self.pcfg.reference_genome_path())

        # Sequence data streams through disk spools (spool.py) so peak RAM
        # stays ~= one partition's compressed blobs, never the raw corpus
        # (the reference's zstd-table pattern, preprocessor.cpp:255-333).
        # By default the spools live in a PERSISTENT resume workdir under
        # intermediate_results_directory with per-stage commit manifests —
        # the reference's file-backed ingest database
        # (preprocessing_database.cpp:39): a crashed run restarts from the
        # last committed stage.
        self._resume = self._make_resume_store(reference_genomes)
        try:
            if self._resume is not None:
                workdir_ctx = contextlib.nullcontext(self._resume.workdir)
            else:
                spool_parent = self.pcfg.intermediate_results_directory
                workdir_ctx = tempfile.TemporaryDirectory(
                    prefix="silo_spool_",
                    dir=spool_parent if os.path.isdir(spool_parent) else None,
                )
            with workdir_ctx as tmpdir:
                if self.pcfg.ndjson_input_filename:
                    table, sequences, unaligned = self._load_ndjson(
                        reference_genomes, tmpdir)
                else:
                    table = self._load_metadata_tsv_resumable(tmpdir)
                    sequences, unaligned = None, None

                db = self._build_database(
                    table, alias_key, reference_genomes, sequences, unaligned,
                    tmpdir
                )
            if self._resume is not None:
                self._resume.clear()
        finally:
            # release the workdir flock even on a crash mid-build: a retry
            # (same or another process) must be able to RESUME from the
            # committed stages instead of falling back to a tempdir
            if self._resume is not None:
                self._resume.close()
        db.data_version = DataVersion.mine()
        logger.info("preprocessing took %.1f s", time.time() - t0)
        return db

    def _make_resume_store(self, reference_genomes: ReferenceGenomes):
        """A ResumeStore bound to this run's input/config signature, or
        None when the intermediate directory is unusable. The workdir is
        per-signature, so concurrent runs over different corpora never
        share state and a changed input can never read stale stages."""
        import os

        from .resume import ResumeStore, compute_signature, file_fingerprint

        parts = [repr(self.config.schema)]  # dataclass: stable field repr
        parts.append(file_fingerprint(self.pcfg.reference_genome_path()))
        pango = self.pcfg.pango_lineage_definition_path()
        if pango:
            parts.append(file_fingerprint(pango))
        if self.pcfg.ndjson_input_filename:
            parts.append("ndjson:" + file_fingerprint(self.pcfg.ndjson_path()))
        else:
            parts.append("tsv:" + file_fingerprint(self.pcfg.metadata_path()))
            # FASTA inputs resolve as <prefix><name>.fasta[.zst|.xz]
            # (readers.open_maybe_compressed) — fingerprint the REAL
            # filenames, not the extension-less stems, or edited FASTA
            # content would never invalidate committed stages
            for name in reference_genomes.raw_nucleotide_sequences:
                parts.append(file_fingerprint(
                    self.pcfg.nuc_filename_no_extension(name) + ".fasta"))
                parts.append(file_fingerprint(
                    self.pcfg.unaligned_nuc_filename_no_extension(name)
                    + ".fasta"))
            for name in reference_genomes.raw_aa_sequences:
                parts.append(file_fingerprint(
                    self.pcfg.gene_filename_no_extension(name) + ".fasta"))
        signature = compute_signature(parts)
        parent = self.pcfg.intermediate_results_directory or "./temp/"
        workdir = os.path.join(parent, f"silo_resume_{signature}")
        try:
            store = ResumeStore(workdir, signature)
        except OSError as ex:
            logger.warning("resume store unavailable (%s) — using tempdir", ex)
            return None
        if store.any_stage_committed():
            logger.info("resuming preprocessing from committed stages in %s",
                        workdir)
        return store

    # -- inputs ---------------------------------------------------------------

    def _load_metadata_tsv_resumable(self, tmpdir: str) -> MetadataTable:
        """_load_metadata_tsv behind a "scan" stage manifest (columnar
        table dump), mirroring the NDJSON path's resume behavior."""
        resume = getattr(self, "_resume", None)
        if resume is None:
            return self._load_metadata_tsv()
        from .resume import load_metadata_table, save_metadata_table

        dump = os.path.join(tmpdir, "metadata_table.npz")
        if resume.done("scan"):
            table = load_metadata_table(dump)
            logger.info("scan stage resumed: %d rows", table.n_rows)
            return table
        table = self._load_metadata_tsv()
        save_metadata_table(table, dump)
        resume.commit("scan", {"n_rows": table.n_rows})
        return table

    def _load_metadata_tsv(self) -> MetadataTable:
        """Streams the TSV straight into a dictionary-encoded columnar
        table: RAM scales with distinct values, not rows (the row-dict
        form costs ~1.1 GB per million rows)."""
        import csv

        field_names = [m.name for m in self.config.schema.metadata]
        with open(self.pcfg.metadata_path(), encoding="utf-8", newline="") as f:
            reader = csv.reader(f, delimiter="\t")
            header = next(reader)
            for metadata in self.config.schema.metadata:
                if metadata.name not in header:
                    raise PreprocessingError(
                        f"The metadata field '{metadata.name}' which is contained in the database "
                        "config is not contained in the metadata file."
                    )
            col_idx = {name: header.index(name) for name in field_names}
            table = MetadataTable(field_names)
            for raw in reader:
                if not raw:
                    continue
                table.append(
                    lambda f, raw=raw: raw[col_idx[f]] if col_idx[f] < len(raw) else ""
                )
        return table

    def _load_ndjson(self, reference_genomes: ReferenceGenomes, tmpdir: str,
                     sequences_enabled: bool = True):
        """NDJSON line format (reference preprocessor.cpp:87-131):
        {metadata: {...}, alignedNucleotideSequences: {name: seq|null}, ...}

        Sequences go straight into single-partition disk spools keyed by
        global row id (spool.py) — only the metadata rows stay in RAM,
        mirroring the reference's zstd-compressed DuckDB sequence tables."""
        import json

        path = self.pcfg.ndjson_path()
        table = MetadataTable([m.name for m in self.config.schema.metadata])
        nuc_names = list(reference_genomes.raw_nucleotide_sequences)
        gene_names = list(reference_genomes.raw_aa_sequences)
        sequences: dict[tuple[str, str], SequenceSpool] = {}
        unaligned: dict[str, SequenceSpool] = {}
        if sequences_enabled:
            for name in nuc_names:
                ref = reference_genomes.raw_nucleotide_sequences[name].encode("ascii")
                sequences[("nuc", name)] = SequenceSpool(tmpdir, f"g_nuc_{name}", 1, ref)
                unaligned[name] = SequenceSpool(tmpdir, f"g_unc_{name}", 1, ref)
            for name in gene_names:
                ref = reference_genomes.raw_aa_sequences[name].encode("ascii")
                sequences[("aa", name)] = SequenceSpool(tmpdir, f"g_aa_{name}", 1, ref)

        resume = getattr(self, "_resume", None)
        if resume is not None and resume.done("scan"):
            # committed scan stage: the global spool files are complete on
            # disk and the metadata table reloads columnar — skip the scan
            from .resume import load_metadata_table

            table = load_metadata_table(
                os.path.join(tmpdir, "metadata_table.npz"))
            logger.info("scan stage resumed: %d rows, spools on disk",
                        table.n_rows)
            return table, sequences, unaligned
        if resume is not None:
            # partial scan from a crashed run: spool frames would append
            # after re-scanned duplicates (harmless for correctness —
            # last frame per row wins — but pure disk bloat); start clean
            for spool in (*sequences.values(), *unaligned.values()):
                spool.reset()

        # precomputed once: the per-record loop over schema fields (with
        # enum-attribute accesses) measured ~5% of a 500k-row ingest
        nuc_ins_fields = [m.name for m in self.config.schema.metadata
                          if m.type.value == "insertion"]
        aa_ins_fields = [m.name for m in self.config.schema.metadata
                         if m.type.value == "aaInsertion"]
        has_ins_fields = bool(nuc_ins_fields or aa_ins_fields)

        def flatten_insertions(metadata, nuc_ins, aa_ins):
            # insertion lists -> comma-joined strings (metadata_info.cpp:62-97)
            # reference metadata_info.cpp:60-95: insertion lists flatten
            # to "<sequence>:<pos>:<value>" entries (always prefixed)
            for name in nuc_ins_fields:
                if name not in metadata:
                    parts = []
                    for seq_name in nuc_names:
                        for ins in nuc_ins.get(seq_name, []):
                            parts.append(f"{seq_name}:{ins}")
                    metadata[name] = ",".join(parts)
            for name in aa_ins_fields:
                if name not in metadata:
                    parts = []
                    for gene in gene_names:
                        for ins in aa_ins.get(gene, []):
                            parts.append(f"{gene}:{ins}")
                    metadata[name] = ",".join(parts)

        def validate_first_record_keys(got_by_field):
            # Validate sequence keys vs reference genomes on the first
            # record (reference sequence_info.cpp:80-130).
            for field_name, expected in (
                ("alignedNucleotideSequences", set(nuc_names)),
                ("alignedAminoAcidSequences", set(gene_names)),
            ):
                missing = expected - got_by_field[field_name]
                if missing:
                    raise PreprocessingError(
                        f"The field '{field_name}' in the input file does not "
                        f"contain the sequences {sorted(missing)} required by "
                        "the reference genomes."
                    )

        def handle_record(record):
            """The reference-semantics per-record path (json.loads form)."""
            if not table.n_rows and sequences_enabled:
                validate_first_record_keys({
                    field: set(record.get(field, {}))
                    for field in ("alignedNucleotideSequences",
                                  "alignedAminoAcidSequences")
                })
            metadata = dict(record.get("metadata", {}))
            flatten_insertions(metadata,
                               record.get("nucleotideInsertions", {}),
                               record.get("aminoAcidInsertions", {}))
            row_id = table.n_rows
            table.append_row_dict(metadata)
            if not sequences_enabled:
                return
            aligned = record.get("alignedNucleotideSequences", {})
            for name in nuc_names:
                sequences[("nuc", name)].add(0, row_id, aligned.get(name))
            aligned_aa = record.get("alignedAminoAcidSequences", {})
            for name in gene_names:
                sequences[("aa", name)].add(0, row_id, aligned_aa.get(name))
            unaligned_seqs = record.get("unalignedNucleotideSequences", {})
            for name in nuc_names:
                unaligned[name].add(0, row_id, unaligned_seqs.get(name))

        scanner = self._make_ndjson_scanner(
            reference_genomes, include_segments=sequences_enabled)
        logger.info("scanning %s with %s", path,
                    "the native scanner (libsilo_ndjson.so)"
                    if scanner is not None else "the Python loop")
        if scanner is not None:
            self._scan_ndjson_native(
                path, scanner, table, sequences, unaligned,
                nuc_names, gene_names, handle_record,
                validate_first_record_keys if sequences_enabled else None,
                flatten_insertions, has_ins_fields)
        else:
            f = None
            for candidate in (path, path + ".zst", path + ".xz"):
                f = readers.open_text_stream(candidate, encoding="utf-8")
                if f is not None:
                    break
            if f is None:
                raise PreprocessingError(
                    f"The specified input file {path} does not exist.")
            with f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    handle_record(json.loads(line))
        for spool in (*sequences.values(), *unaligned.values()):
            spool.finish_writes()
        if resume is not None:
            from .resume import save_metadata_table

            save_metadata_table(
                table, os.path.join(tmpdir, "metadata_table.npz"))
            resume.commit("scan", {"n_rows": table.n_rows})
        return table, sequences, unaligned

    def _make_ndjson_scanner(self, reference_genomes: ReferenceGenomes,
                             include_segments: bool = True):
        """Native NDJSON scanner (C++ tokenize + dict-compress), or None to
        use the pure-Python loop (SILO_NDJSON_NATIVE=0 or lib unavailable).
        include_segments=False tokenizes metadata/insertion spans only (no
        sequence extraction or compression — the sharded-ingest
        coordinator's metadata pass)."""
        import os

        if os.environ.get("SILO_NDJSON_NATIVE", "1") == "0":
            return None
        try:
            from .native_ndjson import NativeNdjsonScanner
        except Exception:  # noqa: BLE001
            return None
        segments = []
        if include_segments:
            for name, ref in reference_genomes.raw_nucleotide_sequences.items():
                segments.append((name, 0, ref.encode("ascii")))
            for name, ref in reference_genomes.raw_aa_sequences.items():
                segments.append((name, 1, ref.encode("ascii")))
            for name, ref in reference_genomes.raw_nucleotide_sequences.items():
                segments.append((name, 2, ref.encode("ascii")))
        try:
            return NativeNdjsonScanner(segments)
        except OSError:
            return None

    def _scan_ndjson_native(self, path, scanner, table, sequences, unaligned,
                            nuc_names, gene_names, handle_record,
                            validate_first_record_keys, flatten_insertions,
                            has_ins_fields=True):
        """Batched native-scanner ingest loop. Segment spool targets are
        aligned with the scanner's segment order (nuc, aa, unaligned);
        records the scanner rejects re-parse through handle_record — the
        semantics are the pure-Python path's, only the common case is fast."""
        import json

        from .native_ndjson import BLOB_ABSENT

        targets = (
            [sequences[("nuc", name)] for name in nuc_names]
            + [sequences[("aa", name)] for name in gene_names]
            + [unaligned[name] for name in nuc_names]
        ) if sequences else []  # metadata-only scan: scanner has 0 segments
        n_nuc, n_aa = len(nuc_names), len(gene_names)

        f = None
        for candidate in (path, path + ".zst", path + ".xz"):
            f = readers.open_binary_stream(candidate)
            if f is not None:
                break
        if f is None:
            raise PreprocessingError(
                f"The specified input file {path} does not exist.")
        BATCH = 512  # ctypes call overhead amortizes over the batch
        with f:
            batch: list[bytes] = []

            def flush():
                for line, rec in zip(batch, scanner.parse(batch)):
                    if rec.status < 0:
                        handle_record(json.loads(line))
                        continue
                    if not table.n_rows and validate_first_record_keys is not None:
                        got_nuc = {
                            nuc_names[s]
                            for s in range(n_nuc)
                            if rec.blobs[s] != BLOB_ABSENT
                        }
                        got_aa = {
                            gene_names[s]
                            for s in range(n_aa)
                            if rec.blobs[n_nuc + s] != BLOB_ABSENT
                        }
                        validate_first_record_keys({
                            "alignedNucleotideSequences": got_nuc,
                            "alignedAminoAcidSequences": got_aa,
                        })

                    def load_span(span):
                        if span is None:
                            return {}
                        off, length = span
                        # decode before json.loads: bytes input runs
                        # json.detect_encoding per call (~5% of a 500k
                        # ingest at 3 spans/record)
                        return json.loads(
                            line[off:off + length].decode("utf-8"))

                    # load_span returns {} only when the key is ABSENT; a
                    # JSON null comes back as None so dict(None)/.get raise
                    # exactly like the pure-Python record.get(...) path.
                    metadata = dict(load_span(rec.meta_span))
                    if has_ins_fields:
                        # schemas without insertion columns never read the
                        # insertion objects — skipping their parse drops
                        # 2/3 of the per-record json.loads calls
                        flatten_insertions(metadata,
                                           load_span(rec.nuc_ins_span),
                                           load_span(rec.aa_ins_span))
                    row_id = table.n_rows
                    table.append_row_dict(metadata)
                    for s, blob in enumerate(rec.blobs):
                        if isinstance(blob, bytes):
                            targets[s].add_compressed(0, row_id, blob)
                batch.clear()

            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                batch.append(raw)
                if len(batch) >= BATCH:
                    flush()
            if batch:
                flush()

    # -- build ----------------------------------------------------------------

    def _build_database(
        self,
        table: MetadataTable,
        alias_key: PangoLineageAliasLookup,
        reference_genomes: ReferenceGenomes,
        ndjson_sequences=None,
        ndjson_unaligned=None,
        tmpdir: str | None = None,
        skip_sequences: bool = False,
    ) -> Database:
        import numpy as np

        config = self.config
        db = Database(config, alias_key, reference_genomes)
        n_rows = table.n_rows

        # 1. Partition assignment (partitioner.py), vectorized over the
        #    dictionary codes: counts come from one bincount, the
        #    key->partition map is applied per CODE, not per row.
        partition_by = config.schema.partition_by
        if partition_by is not None:
            codes = table.codes(partition_by)
            values = table.values[partition_by]
            counts = np.bincount(codes, minlength=len(values))
            items = [
                ((values[c] if values[c] != "" else None), int(counts[c]))
                for c in range(len(values)) if counts[c] > 0
            ]
            ordered_keys = sorted(items, key=lambda kv: sort_key_nulls_first(kv[0]))
            groups = partition_keys(ordered_keys)
            key_to_partition = {}
            for pid, group in enumerate(groups):
                for key in group:
                    key_to_partition[key] = pid
            n_partitions = len(groups)
            code_to_partition = np.array(
                [key_to_partition.get(values[c] if values[c] != "" else None, 0)
                 for c in range(len(values))],
                dtype=np.int32,
            )
            row_partition = code_to_partition[codes]
        else:
            n_partitions = 1
            row_partition = np.zeros(n_rows, dtype=np.int32)

        # 2. Row order within partitions: (date NULLS FIRST via 0-encoding,
        #    primary key) — one global stable lexsort, then split by
        #    partition (relative order survives the split).
        primary_key = config.schema.primary_key
        date_to_sort_by = config.schema.date_to_sort_by
        pk_strings = table.strings(primary_key)
        if date_to_sort_by is not None:
            date_by_code = np.array(
                [string_to_date(v) for v in table.values[date_to_sort_by]],
                dtype=np.uint32,
            )
            date_values = date_by_code[table.codes(date_to_sort_by)]
            order = np.lexsort((pk_strings, date_values))
        else:
            order = np.argsort(pk_strings, kind="stable")
        row_ids_per_partition = [
            order[row_partition[order] == pid] for pid in range(n_partitions)
        ]

        # 3. Column skeletons with cross-partition dictionaries.
        pango_dicts = {}
        for metadata in config.schema.metadata:
            column_type = metadata.column_type()
            if column_type in (ColumnType.STRING, ColumnType.INDEXED_STRING,
                               ColumnType.NUC_INSERTION, ColumnType.AA_INSERTION):
                db.dictionaries[metadata.name] = Dictionary()
            elif column_type == ColumnType.INDEXED_PANGOLINEAGE:
                pango_dicts[metadata.name] = (Dictionary(), Dictionary())
                db.dictionaries[metadata.name] = pango_dicts[metadata.name]

        partitions = []
        for pid in range(n_partitions):
            row_ids = row_ids_per_partition[pid]
            partition = DatabasePartition(pid, len(row_ids))
            for metadata in config.schema.metadata:
                column_type = metadata.column_type()
                if column_type == ColumnType.STRING:
                    col = StringColumnPartition(db.dictionaries[metadata.name])
                elif column_type == ColumnType.INDEXED_STRING:
                    col = IndexedStringColumnPartition(db.dictionaries[metadata.name])
                elif column_type == ColumnType.DATE:
                    col = DateColumnPartition(metadata.name == date_to_sort_by)
                elif column_type == ColumnType.INT:
                    col = IntColumnPartition()
                elif column_type == ColumnType.FLOAT:
                    col = FloatColumnPartition()
                elif column_type == ColumnType.INDEXED_PANGOLINEAGE:
                    unaliased, aliased = pango_dicts[metadata.name]
                    col = PangoLineageColumnPartition(alias_key, unaliased, aliased)
                elif column_type == ColumnType.NUC_INSERTION:
                    col = InsertionColumnPartition(
                        db.dictionaries[metadata.name],
                        config.default_nucleotide_sequence,
                        NUCLEOTIDE,
                        "nuc_insertion",
                    )
                elif column_type == ColumnType.AA_INSERTION:
                    col = InsertionColumnPartition(
                        db.dictionaries[metadata.name], None, AMINO_ACID, "aa_insertion"
                    )
                else:
                    raise PreprocessingError(f"Unhandled column type {column_type}")
                partition.columns[metadata.name] = col

            # 4. Bulk-fill metadata columns in partition row order: per
            #    column, convert each DISTINCT value once (in first-
            #    occurrence order over the partition traversal, so shared
            #    dictionaries get identical ids to row-wise insertion) and
            #    load per-row codes through the columns' snapshot path.
            for metadata in config.schema.metadata:
                _bulk_fill_column(
                    partition.columns[metadata.name], metadata.column_type(),
                    table, metadata.name, row_ids, db, alias_key,
                )
            partitions.append(partition)
        db.partitions = partitions

        # 5. Sequence stores (dense bitplanes) + unaligned stores, streamed
        #    through per-partition disk spools: assignment maps global row id
        #    -> (partition, partition-local row), sequences flow spool ->
        #    SegmentIndexBuilder in SEQUENCE_BATCH batches, and raw genomes
        #    never accumulate in RAM (reference preprocessor.cpp:255-333).
        key_by_row = pk_strings
        assignment: list[tuple[int, int]] = [(0, 0)] * n_rows
        for pid, row_ids in enumerate(row_ids_per_partition):
            for local_row, i in enumerate(row_ids):
                assignment[i] = (pid, local_row)
        if skip_sequences:
            # sharded ingest (preprocessing/sharded.py): the coordinator
            # builds the metadata side only; worker processes fill the
            # sequence stores from the stashed global-row -> (partition,
            # local row) assignment
            db._ingest_assignment = assignment
            return db
        # (built once — every FASTA file routes through it)
        key_to_slot = (
            {key_by_row[i]: assignment[i] for i in range(n_rows)}
            if ndjson_sequences is None else None
        )

        resume = getattr(self, "_resume", None)

        def fill_segment(kind: str, name: str, reference_ids, spool: SequenceSpool):
            for pid, partition in enumerate(partitions):
                builder = SegmentIndexBuilder(
                    NUCLEOTIDE if kind == "nuc" else AMINO_ACID,
                    reference_ids,
                    partition.sequence_count,
                )
                batch: list[str | None] = []
                for seq in spool.iter_rows(pid, partition.sequence_count):
                    batch.append(seq)
                    if len(batch) >= SEQUENCE_BATCH:
                        builder.add_batch(batch)
                        batch = []
                if batch:
                    builder.add_batch(batch)
                segment = builder.finish()
                if kind == "nuc":
                    partition.nuc_sequences[name] = segment
                else:
                    partition.aa_sequences[name] = segment
            if resume is None:
                # resumable runs keep routed spools until preprocess()
                # completes (a crash mid-BUILD re-fills every segment
                # without re-scanning the input; a crash during the
                # caller's later snapshot save still re-ingests — the
                # workdir is cleared when preprocess returns)
                spool.cleanup()

        def spool_fasta(path_no_ext: str, tag: str, dictionary: bytes,
                        required_error: str | None) -> SequenceSpool | None:
            """Stream a FASTA file (keyed by primary key) into a per-
            partition spool; None if the file is absent and optional.
            Stage-committed when resumable: a later crash re-reads the
            spool, not the FASTA."""
            stage = f"fasta_{tag}"
            if resume is not None:
                payload = resume.payload(stage)
                if payload is not None:
                    if payload.get("absent"):
                        return None
                    return SequenceSpool(tmpdir, tag, n_partitions, dictionary)
            stream = readers.open_maybe_compressed(path_no_ext)
            if stream is None:
                if required_error is not None:
                    raise PreprocessingError(required_error)
                if resume is not None:
                    resume.commit(stage, {"absent": True})
                return None
            spool = SequenceSpool(tmpdir, tag, n_partitions, dictionary)
            if resume is not None:
                spool.reset()
            with stream:
                for key, seq in readers.iter_fasta(stream):
                    slot = key_to_slot.get(key)
                    if slot is not None:
                        spool.add(slot[0], slot[1], seq)
            spool.finish_writes()
            if resume is not None:
                resume.commit(stage, {"absent": False})
            return spool

        def routed(global_spool: SequenceSpool, tag: str) -> SequenceSpool:
            per_part = SequenceSpool(
                tmpdir, tag, n_partitions, global_spool.dictionary)
            stage = f"route_{tag}"
            if resume is not None and resume.done(stage):
                return per_part  # routed files complete on disk
            if resume is not None:
                per_part.reset()
            global_spool.route(per_part, assignment)
            if resume is not None:
                resume.commit(stage, {})
            global_spool.cleanup()
            return per_part

        if ndjson_sequences is not None:
            for (kind, name), global_spool in ndjson_sequences.items():
                reference_ids = (
                    reference_genomes.nucleotide_ids[name]
                    if kind == "nuc"
                    else reference_genomes.aa_ids[name]
                )
                fill_segment(kind, name, reference_ids,
                             routed(global_spool, f"r_{kind}_{name}"))
        else:
            for name, reference_ids in reference_genomes.nucleotide_ids.items():
                ref = reference_genomes.raw_nucleotide_sequences[name].encode("ascii")
                spool = spool_fasta(
                    self.pcfg.nuc_filename_no_extension(name), f"r_nuc_{name}", ref,
                    f"Missing aligned nucleotide sequence file for '{name}'",
                )
                fill_segment("nuc", name, reference_ids, spool)
            for name, reference_ids in reference_genomes.aa_ids.items():
                ref = reference_genomes.raw_aa_sequences[name].encode("ascii")
                spool = spool_fasta(
                    self.pcfg.gene_filename_no_extension(name), f"r_aa_{name}", ref,
                    f"Missing gene sequence file for '{name}'",
                )
                fill_segment("aa", name, reference_ids, spool)

        # Unaligned nucleotide sequences (lazy store for the Fasta action):
        # blobs move spool -> store verbatim (same zstd dictionary).
        for name, reference in reference_genomes.raw_nucleotide_sequences.items():
            ref = reference.encode("ascii")
            if ndjson_unaligned is not None:
                spool = routed(ndjson_unaligned[name], f"r_unc_{name}")
            else:
                spool = spool_fasta(
                    self.pcfg.unaligned_nuc_filename_no_extension(name),
                    f"r_unc_{name}", ref, None,
                )
            stores = []
            for pid, partition in enumerate(partitions):
                store = UnalignedPartitionStore(reference)
                blobs = spool.read_partition(pid) if spool is not None else {}
                for local_row in range(partition.sequence_count):
                    store.add_compressed(blobs.get(local_row))
                stores.append(store)
            if spool is not None and resume is None:
                # resumable runs keep the spool until the snapshot commits
                # (its stage manifest claims the files exist)
                spool.cleanup()
            db.unaligned_nuc_sequences[name] = stores

        for partition in partitions:
            partition.validate()
        return db


def _first_occurrence_codes(codes_p):
    """Distinct codes of one partition's rows, ordered by first occurrence
    (so shared-dictionary id assignment matches row-wise insertion)."""
    import numpy as np

    uniq, first = np.unique(codes_p, return_index=True)
    return uniq[np.argsort(first)]


def _standardize_insertions(value: str, default_sequence_name: str | None) -> str:
    """InsertionColumnPartition.insert's value standardization, applied once
    per distinct value (same parse errors, columns.py:318-348)."""
    from ..storage.columns import _parse_u32

    parts_out = []
    for entry in value.split(","):
        parts = [p.replace('"', "") for p in entry.split(":")]
        if len(parts) == 2:
            if default_sequence_name is None:
                raise ValueError(
                    f"Failed to parse insertion due to invalid format: {entry}"
                )
            sequence_name, position, insertion = (
                default_sequence_name, _parse_u32(parts[0], entry), parts[1])
        elif len(parts) == 3:
            sequence_name, position, insertion = (
                parts[0], _parse_u32(parts[1], entry), parts[2])
        else:
            raise ValueError(
                f"Failed to parse insertion due to invalid format: {entry}"
            )
        if sequence_name == default_sequence_name:
            parts_out.append(f"{position}:{insertion}")
        else:
            parts_out.append(f"{sequence_name}:{position}:{insertion}")
    return ",".join(parts_out)


def _bulk_fill_column(col, column_type, table: MetadataTable, name: str,
                      row_ids, db, alias_key):
    """Fill one partition's column from the columnar table: per-DISTINCT-
    value conversion + a vectorized per-row code remap, loading through the
    same path snapshots use (column.load_ids / _values+finalize). Behavior
    (null sentinels, dictionary id order, parse errors) matches row-wise
    insert()."""
    import numpy as np

    from ..common.dates import string_to_date as to_date
    from ..storage.columns import INT_NULL
    from ..storage.pango_alias import PangoLineageAliasLookup as Alias

    codes_p = np.asarray(table.codes(name))[row_ids]
    values = table.values[name]
    order = _first_occurrence_codes(codes_p) if len(codes_p) else []

    if column_type in (ColumnType.STRING, ColumnType.INDEXED_STRING):
        dictionary = db.dictionaries[name]
        id_map = np.zeros(len(values), dtype=np.int32)
        for c in order:
            id_map[c] = dictionary.get_or_create(values[c])
        col.load_ids(id_map[codes_p])
    elif column_type == ColumnType.INDEXED_PANGOLINEAGE:
        unaliased_dict, aliased_dict = db.dictionaries[name]
        id_map = np.zeros(len(values), dtype=np.int32)
        for c in order:
            unaliased = alias_key.unalias(values[c])
            for parent in Alias.parent_lineages(unaliased):
                unaliased_dict.get_or_create(parent)
                aliased_dict.get_or_create(alias_key.alias(parent))
            id_map[c] = unaliased_dict.get_or_create(unaliased)
            aliased_dict.get_or_create(alias_key.alias(unaliased))
        col.load_ids(id_map[codes_p])
    elif column_type in (ColumnType.NUC_INSERTION, ColumnType.AA_INSERTION):
        dictionary = db.dictionaries[name]
        id_map = np.zeros(len(values), dtype=np.int32)
        for c in order:
            value = values[c]
            standardized = (
                _standardize_insertions(value, col.default_sequence_name)
                if value else ""
            )
            id_map[c] = dictionary.get_or_create(standardized)
        col.load_ids(id_map[codes_p])
    elif column_type == ColumnType.INT:
        value_map = np.full(len(values), INT_NULL, dtype=np.int32)
        for c in order:
            v = values[c]
            try:
                value_map[c] = int(v) if v != "" else INT_NULL
            except (ValueError, OverflowError):
                value_map[c] = INT_NULL
        col._values = value_map[codes_p]
        col.finalize()
    elif column_type == ColumnType.FLOAT:
        value_map = np.full(len(values), np.nan, dtype=np.float64)
        for c in order:
            v = values[c]
            try:
                value_map[c] = float(v) if v != "" else float("nan")
            except ValueError:
                value_map[c] = float("nan")
        col._values = value_map[codes_p]
        col.finalize()
    elif column_type == ColumnType.DATE:
        value_map = np.zeros(len(values), dtype=np.uint32)
        for c in order:
            value_map[c] = to_date(values[c])
        col._values = value_map[codes_p]
        col.finalize()
    else:
        raise PreprocessingError(f"Unhandled column type {column_type}")
