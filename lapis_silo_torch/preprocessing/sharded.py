"""Sharded multi-process NDJSON ingest.

The reference's `buildDatabase` is internally TBB-parallel end-to-end
(src/silo/preprocessing/preprocessor.cpp:447-503: metadata
fill and per-partition sequence-store fills run under task groups); a
single-process Python ingest is bound by the zstd compression in the
native scanner's worker threads instead. This module splits the SEQUENCE
work — the dominant cost — across N worker processes, each of which runs
``python -m lapis_silo_torch.preprocessing.sharded``:

1. **Plan** (coordinator, in-process): one metadata-only scan (native
   tokenizer with no sequence segments — no compression) builds the
   MetadataTable, the partitioner, every metadata column, and the shared
   dictionaries. This is the global state workers must agree on, so it is
   computed exactly once.
2. **Shard** (N subprocesses): each worker re-streams the NDJSON text,
   skips lines whose partition it does not own (partition_id % N != i —
   skipped lines are never JSON-parsed or compressed), spools its lines'
   sequences per partition, builds the SegmentIndex bitplanes + unaligned
   stores for its partitions, and writes them in the snapshot's own
   per-partition file format (storage/snapshot._save_segment /
   _save_unaligned).
3. **Merge** (coordinator): attach each worker's segment files to the
   metadata database (snapshot._load_segment), validate, version.

Sequence bytes are compressed exactly once across the fleet; the extra
cost versus single-process is N cheap re-reads of the input text.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

logger = logging.getLogger(__name__)

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _owned(pid: int, shard: int, n_shards: int) -> bool:
    return pid % n_shards == shard


def sharded_preprocess(pcfg, dbconf, n_shards: int):
    """Full sharded ingest; returns the built Database (same contract as
    Preprocessor.preprocess). NDJSON input only."""
    from ..storage.database import DataVersion
    from .preprocessor import PreprocessingError, Preprocessor

    if not pcfg.ndjson_input_filename:
        raise PreprocessingError(
            "sharded ingest (--ingestShards) supports NDJSON input only")
    if n_shards < 1:
        raise PreprocessingError(f"invalid shard count {n_shards}")

    t0 = time.time()
    pre = Preprocessor(pcfg, dbconf)
    from ..storage.pango_alias import PangoLineageAliasLookup
    from ..storage.reference_genomes import ReferenceGenomes

    pango_path = pcfg.pango_lineage_definition_path()
    alias_key = (PangoLineageAliasLookup.read_from_file(pango_path)
                 if pango_path else PangoLineageAliasLookup())
    reference_genomes = ReferenceGenomes.read_from_file(
        pcfg.reference_genome_path())

    _validate_first_line(pre, pcfg, reference_genomes)

    with tempfile.TemporaryDirectory(prefix="silo_shard_") as plan_dir:
        # Phase 1: metadata-only scan + metadata database (all partitions)
        table, _seq, _unc = pre._load_ndjson(reference_genomes, plan_dir,
                                             sequences_enabled=False)
        db = pre._build_database(table, alias_key, reference_genomes,
                                 ndjson_sequences={}, ndjson_unaligned={},
                                 tmpdir=plan_dir, skip_sequences=True)
        assignment = np.asarray(db._ingest_assignment, dtype=np.int64)
        del db._ingest_assignment  # a tuple per row: not for the served db
        part_counts = np.asarray([p.sequence_count for p in db.partitions],
                                 dtype=np.int64)
        np.savez(os.path.join(plan_dir, "plan.npz"),
                 pid=assignment[:, 0], local=assignment[:, 1],
                 part_counts=part_counts)
        logger.info("sharded ingest plan: %d rows, %d partitions, "
                    "%d shards (%.1f s)", table.n_rows, len(part_counts),
                    n_shards, time.time() - t0)

        # Phase 2: worker fleet
        import dataclasses

        spec = {
            "pcfg": dataclasses.asdict(pcfg),
            "n_shards": n_shards,
        }
        with open(os.path.join(plan_dir, "plan.json"), "w") as f:
            json.dump(spec, f)
        # workers run this package's module and never touch a card; they
        # resolve the package whatever the caller's cwd
        env = dict(os.environ)
        env["PYTHONPATH"] = _PACKAGE_ROOT + os.pathsep + env.get(
            "PYTHONPATH", "")
        procs = []
        for shard in range(n_shards):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lapis_silo_torch.preprocessing.sharded",
                 plan_dir, str(shard)],
                env=env, cwd=os.getcwd()))
        failed = [i for i, p in enumerate(procs) if p.wait() != 0]
        if failed:
            raise PreprocessingError(
                f"ingest shard process(es) {failed} failed")

        # Phase 3: merge worker outputs into the metadata database
        _attach_shard_outputs(db, reference_genomes, plan_dir)

    for partition in db.partitions:
        partition.validate()
    db.data_version = DataVersion.mine()
    logger.info("sharded preprocessing took %.1f s (%d shards)",
                time.time() - t0, n_shards)
    return db


def _validate_first_line(pre, pcfg, reference_genomes):
    """First-record sequence-key validation (reference
    sequence_info.cpp:80-130) — the metadata-only scan never sees the
    sequence keys, so check the first line directly."""
    from . import readers
    from .preprocessor import PreprocessingError

    path = pcfg.ndjson_path()
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
            record = json.loads(line)
            for field_name, expected in (
                ("alignedNucleotideSequences",
                 set(reference_genomes.raw_nucleotide_sequences)),
                ("alignedAminoAcidSequences",
                 set(reference_genomes.raw_aa_sequences)),
            ):
                missing = expected - set(record.get(field_name, {}))
                if missing:
                    raise PreprocessingError(
                        f"The field '{field_name}' in the input file does "
                        f"not contain the sequences {sorted(missing)} "
                        "required by the reference genomes.")
            return


def _attach_shard_outputs(db, reference_genomes, plan_dir):
    from ..common.symbols import AMINO_ACID, NUCLEOTIDE
    from ..storage.snapshot import _load_segment, _load_unaligned

    out_dir = os.path.join(plan_dir, "out")
    for partition in db.partitions:
        pid, n = partition.partition_id, partition.sequence_count
        for name, ref_ids in reference_genomes.nucleotide_ids.items():
            partition.nuc_sequences[name] = _load_segment(
                os.path.join(out_dir, f"P{pid}_nuc_{name}"),
                NUCLEOTIDE, ref_ids, n)
        for name, ref_ids in reference_genomes.aa_ids.items():
            partition.aa_sequences[name] = _load_segment(
                os.path.join(out_dir, f"P{pid}_aa_{name}"),
                AMINO_ACID, ref_ids, n)
    for name, reference in reference_genomes.raw_nucleotide_sequences.items():
        db.unaligned_nuc_sequences[name] = [
            _load_unaligned(
                os.path.join(out_dir, f"P{p.partition_id}_unaligned_{name}"),
                reference)
            for p in db.partitions
        ]


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def run_shard(plan_dir: str, shard: int) -> None:
    """One ingest shard: sequence scan + segment build for the partitions
    this shard owns. Reads plan.{json,npz}; writes snapshot-format segment
    and unaligned files into <plan_dir>/out/."""
    from ..common.symbols import AMINO_ACID, NUCLEOTIDE
    from ..storage.reference_genomes import ReferenceGenomes
    from ..storage.segment import SegmentIndexBuilder
    from ..storage.snapshot import _save_segment, _save_unaligned
    from ..storage.unaligned import UnalignedPartitionStore
    from . import readers
    from .preprocessing_config import PreprocessingConfig
    from .preprocessor import SEQUENCE_BATCH, PreprocessingError, Preprocessor
    from .spool import SequenceSpool

    with open(os.path.join(plan_dir, "plan.json")) as f:
        spec = json.load(f)
    pcfg = PreprocessingConfig(**spec["pcfg"])
    n_shards = spec["n_shards"]
    plan = np.load(os.path.join(plan_dir, "plan.npz"))
    pid_of = plan["pid"]
    local_of = plan["local"]
    part_counts = plan["part_counts"]
    n_partitions = len(part_counts)
    owned_pids = [p for p in range(n_partitions)
                  if _owned(p, shard, n_shards)]
    reference_genomes = ReferenceGenomes.read_from_file(
        pcfg.reference_genome_path())
    nuc_names = list(reference_genomes.raw_nucleotide_sequences)
    gene_names = list(reference_genomes.raw_aa_sequences)
    out_dir = os.path.join(plan_dir, "out")
    os.makedirs(out_dir, exist_ok=True)

    with tempfile.TemporaryDirectory(prefix=f"silo_shard{shard}_") as tmpdir:
        spools: dict[tuple[str, str], SequenceSpool] = {}
        unaligned: dict[str, SequenceSpool] = {}
        for name in nuc_names:
            ref = reference_genomes.raw_nucleotide_sequences[name].encode("ascii")
            spools[("nuc", name)] = SequenceSpool(
                tmpdir, f"s_nuc_{name}", n_partitions, ref)
            unaligned[name] = SequenceSpool(
                tmpdir, f"s_unc_{name}", n_partitions, ref)
        for name in gene_names:
            ref = reference_genomes.raw_aa_sequences[name].encode("ascii")
            spools[("aa", name)] = SequenceSpool(
                tmpdir, f"s_aa_{name}", n_partitions, ref)

        # sequence scan over OWNED lines only (the dummy Preprocessor is
        # just a scanner factory — its config is never used for metadata)
        scanner_host = Preprocessor.__new__(Preprocessor)
        scanner = scanner_host._make_ndjson_scanner(reference_genomes)
        targets = (
            [spools[("nuc", name)] for name in nuc_names]
            + [spools[("aa", name)] for name in gene_names]
            + [unaligned[name] for name in nuc_names]
        )

        path = pcfg.ndjson_path()
        f = None
        for candidate in (path, path + ".zst", path + ".xz"):
            f = readers.open_binary_stream(candidate)
            if f is not None:
                break
        if f is None:
            raise PreprocessingError(
                f"The specified input file {path} does not exist.")

        def handle_slow(line: bytes, pid: int, local: int):
            record = json.loads(line)
            aligned = record.get("alignedNucleotideSequences", {})
            for name in nuc_names:
                spools[("nuc", name)].add(pid, local, aligned.get(name))
            aligned_aa = record.get("alignedAminoAcidSequences", {})
            for name in gene_names:
                spools[("aa", name)].add(pid, local, aligned_aa.get(name))
            unaligned_seqs = record.get("unalignedNucleotideSequences", {})
            for name in nuc_names:
                unaligned[name].add(pid, local, unaligned_seqs.get(name))

        BATCH = 512
        with f:
            batch: list[tuple[bytes, int, int]] = []

            def flush():
                if scanner is None:
                    for line, pid, local in batch:
                        handle_slow(line, pid, local)
                else:
                    lines = [b[0] for b in batch]
                    for (line, pid, local), rec in zip(
                            batch, scanner.parse(lines)):
                        if rec.status < 0:
                            handle_slow(line, pid, local)
                            continue
                        for s, blob in enumerate(rec.blobs):
                            if isinstance(blob, bytes):
                                targets[s].add_compressed(pid, local, blob)
                batch.clear()

            row = 0
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                pid = int(pid_of[row])
                if _owned(pid, shard, n_shards):
                    batch.append((raw, pid, int(local_of[row])))
                    if len(batch) >= BATCH:
                        flush()
                row += 1
            if batch:
                flush()
        for spool in (*spools.values(), *unaligned.values()):
            spool.finish_writes()

        # build + save segments for owned partitions
        for (kind, name), spool in spools.items():
            ref_ids = (reference_genomes.nucleotide_ids[name] if kind == "nuc"
                       else reference_genomes.aa_ids[name])
            alphabet = NUCLEOTIDE if kind == "nuc" else AMINO_ACID
            for pid in owned_pids:
                builder = SegmentIndexBuilder(alphabet, ref_ids,
                                              int(part_counts[pid]))
                seq_batch: list[str | None] = []
                for seq in spool.iter_rows(pid, int(part_counts[pid])):
                    seq_batch.append(seq)
                    if len(seq_batch) >= SEQUENCE_BATCH:
                        builder.add_batch(seq_batch)
                        seq_batch = []
                if seq_batch:
                    builder.add_batch(seq_batch)
                _save_segment(os.path.join(out_dir, f"P{pid}_{kind}_{name}"),
                              builder.finish())
            spool.cleanup()
        for name, spool in unaligned.items():
            reference = reference_genomes.raw_nucleotide_sequences[name]
            for pid in owned_pids:
                store = UnalignedPartitionStore(reference)
                blobs = spool.read_partition(pid)
                for local_row in range(int(part_counts[pid])):
                    store.add_compressed(blobs.get(local_row))
                _save_unaligned(
                    os.path.join(out_dir, f"P{pid}_unaligned_{name}"), store)
            spool.cleanup()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    run_shard(sys.argv[1], int(sys.argv[2]))
