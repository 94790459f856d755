"""Resumable preprocessing intermediates.

The reference can persist its ingest database and restart preprocessing
from it (file-backed DuckDB at
src/silo/preprocessing/preprocessing_database.cpp:39,
selected by `intermediate_results_directory` in the preprocessing
config). The analog here: when `intermediate_results_directory` is
configured, spools and the scanned metadata table live in a PERSISTENT
work directory instead of a per-run tempdir, and each completed stage
(NDJSON scan, per-segment routing, per-FASTA spooling) commits a
manifest-last JSON marker — the snapshot protocol's commit discipline
(storage/snapshot.py) applied to ingest. A crash at minute 17 of an
18-minute build restarts from the last committed stage instead of from
zero.

A stage manifest binds to a SIGNATURE of (input files' path/size/mtime,
database config, schema-relevant preprocessing config): any input or
config change invalidates every stage, so a resume can never mix state
from two different corpora.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil

logger = logging.getLogger(__name__)

_MANIFEST_SUFFIX = ".stage.json"


def file_fingerprint(path: str) -> str:
    """Cheap identity for an input file: path, size, mtime_ns. (Hashing
    10M-row NDJSON contents would cost a full extra read per run.)"""
    for candidate in (path, path + ".zst", path + ".xz"):
        if candidate and os.path.exists(candidate):
            st = os.stat(candidate)
            return f"{candidate}:{st.st_size}:{st.st_mtime_ns}"
    return f"{path}:absent"


def compute_signature(parts: list[str]) -> str:
    digest = hashlib.sha256()
    for part in parts:
        digest.update(part.encode("utf-8", "replace"))
        digest.update(b"\0")
    return digest.hexdigest()[:24]


class ResumeStore:
    """Stage-manifest bookkeeping over a persistent work directory.

    Stage data (spool files, the table dump) is written directly into
    `workdir` by the preprocessor; `commit(stage)` then records the stage
    as complete ATOMICALLY (tmp + rename, manifest written last) together
    with the run signature. `done(stage)` is True only when the manifest
    exists AND its signature matches this run's inputs."""

    def __init__(self, workdir: str, signature: str):
        self.signature = signature
        self._lock_fd: int | None = None
        self.ephemeral = False
        os.makedirs(workdir, exist_ok=True)
        # Exclusive per-workdir lock: two simultaneous preprocess runs over
        # the same inputs compute the same signature and would interleave
        # 'ab' spool appends with each other's stage commits — a committed
        # 'scan' manifest could then describe spool files another live
        # process is still appending to. flock (not an O_EXCL pid marker)
        # so a crashed holder releases automatically.
        import fcntl

        fd = os.open(os.path.join(workdir, ".lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            self._lock_fd = fd
            self.workdir = workdir
        except OSError:
            os.close(fd)
            import tempfile

            self.workdir = tempfile.mkdtemp(prefix="silo_resume_")
            self.ephemeral = True
            logger.warning(
                "resume workdir %s is locked by another preprocessing run "
                "— using throwaway %s (this run will not be resumable)",
                workdir, self.workdir)

    def _manifest_path(self, stage: str) -> str:
        safe = stage.replace("/", "_")
        return os.path.join(self.workdir, safe + _MANIFEST_SUFFIX)

    def done(self, stage: str) -> bool:
        return self.payload(stage) is not None

    def payload(self, stage: str) -> dict | None:
        path = self._manifest_path(stage)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if manifest.get("signature") != self.signature:
            return None
        return manifest.get("payload", {})

    def commit(self, stage: str, payload: dict | None = None) -> None:
        path = self._manifest_path(stage)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"signature": self.signature,
                       "stage": stage,
                       "payload": payload or {}}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        logger.info("preprocessing stage committed: %s", stage)

    def any_stage_committed(self) -> bool:
        return any(name.endswith(_MANIFEST_SUFFIX)
                   for name in os.listdir(self.workdir))

    def close(self) -> None:
        if self._lock_fd is not None:
            os.close(self._lock_fd)  # flock releases with the fd
            self._lock_fd = None

    def clear(self) -> None:
        self.close()
        shutil.rmtree(self.workdir, ignore_errors=True)


def save_metadata_table(table, path: str) -> None:
    """Dump a MetadataTable columnar: one int32 code array per field
    (npz) + the per-field unique value lists (json). Atomic via tmp +
    rename on the final file read back first (the npz)."""
    import numpy as np

    values_path = path + ".values.json"
    with open(values_path + ".tmp", "w") as f:
        json.dump({"fields": table.fields, "n_rows": table.n_rows,
                   "values": table.values}, f)
    os.replace(values_path + ".tmp", values_path)
    arrays = {f"codes_{i}": table.codes(field)
              for i, field in enumerate(table.fields)}
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)


def load_metadata_table(path: str):
    import numpy as np

    from .table import MetadataTable
    from array import array

    with open(path + ".values.json") as f:
        head = json.load(f)
    table = MetadataTable(head["fields"])
    with np.load(path) as arrays:
        for i, field in enumerate(table.fields):
            codes = arrays[f"codes_{i}"]
            table._codes[field] = array("i", codes.tolist())
            table.values[field] = list(head["values"][field])
            table._ids[field] = {v: j
                                 for j, v in enumerate(table.values[field])}
    table.n_rows = int(head["n_rows"])
    return table
