"""Database facade: owns partitions, columns dictionaries, sequence metadata.

Parity with reference src/silo/database.cpp (minus boost archives — snapshots
are flat arrays + a JSON manifest, see storage/snapshot.py).
"""

from __future__ import annotations

import time

from ..common.symbols import NUCLEOTIDE
from ..config.database_config import ColumnType, DatabaseConfig
from .pango_alias import PangoLineageAliasLookup
from .partition import DatabasePartition
from .reference_genomes import ReferenceGenomes


class DataVersion:
    """Unix-timestamp string; lexicographic ordering (common/data_version.cpp)."""

    def __init__(self, value: str):
        self.value = value

    @classmethod
    def mine(cls) -> "DataVersion":
        return cls(str(int(time.time())))

    @classmethod
    def validate(cls, value: str) -> bool:
        return value.isdigit() and len(value) > 0

    def __lt__(self, other):
        return self.value < other.value


class _MapAtError(KeyError):
    """std::map::at out_of_range replica: libstdc++'s what() is the bare
    string "map::at" (no key), and the 500 JSON body carries it verbatim —
    KeyError's default str() would quote the key instead."""

    def __str__(self):
        return "map::at"


class Database:
    def __init__(
        self,
        config: DatabaseConfig,
        alias_key: PangoLineageAliasLookup,
        reference_genomes: ReferenceGenomes,
    ):
        self.config = config
        self.alias_key = alias_key
        self.reference_genomes = reference_genomes
        self.partitions: list[DatabasePartition] = []
        # Cross-partition dictionaries per column name
        self.dictionaries: dict[str, object] = {}
        # name -> reference id arrays (aligned segments present in the index)
        self.nuc_sequences: dict[str, object] = dict(reference_genomes.nucleotide_ids)
        self.aa_sequences: dict[str, object] = dict(reference_genomes.aa_ids)
        # unaligned stores: segment name -> list per partition
        self.unaligned_nuc_sequences: dict[str, list] = {}
        self.data_version: DataVersion = DataVersion("")
        self._engine = None  # lazily created query engine
        self._roaring_stats = None  # lazily computed /info size model
        import threading

        self._engine_lock = threading.Lock()

    @classmethod
    def empty(cls) -> "Database":
        """A database with no partitions — what the API serves before the
        first snapshot loads (reference api.cpp:178: the server starts with
        a default-constructed Database and keeps serving)."""
        from ..config.database_config import DatabaseSchema

        config = DatabaseConfig(schema=DatabaseSchema(instance_name="", primary_key=""))
        return cls(config, PangoLineageAliasLookup(), ReferenceGenomes({}, {}))

    # -- schema helpers -----------------------------------------------------

    def column_type(self, name: str) -> ColumnType | None:
        metadata = self.config.get_metadata(name)
        return metadata.column_type() if metadata else None

    def sequence_stores(self, alphabet) -> dict:
        return self.nuc_sequences if alphabet is NUCLEOTIDE else self.aa_sequences

    def default_sequence_name(self, alphabet) -> str | None:
        # Reference database.cpp:73-80: the nucleotide default is the config
        # value unconditionally; amino acids have no default sequence.
        if alphabet is NUCLEOTIDE:
            return self.config.default_nucleotide_sequence
        return None

    # -- queries ------------------------------------------------------------

    def execute_query(self, query_string: str) -> dict:
        from ..query.engine import QueryEngine

        with self._engine_lock:
            if self._engine is None:
                self._engine = QueryEngine(self)
        return self._engine.execute(query_string)

    # -- info ---------------------------------------------------------------

    def _nuc_roaring_stats(self):
        """Cached Roaring-model stats per (partition, nuc segment) — the
        reference's /info numbers modeled over our compact bitplane layout
        (storage/roaring_stats.py). Content-determined, so dense and CSR
        builds report identical values. Computed once per immutable
        database."""
        if self._roaring_stats is None:
            from . import roaring_stats

            self._roaring_stats = [
                {name: roaring_stats.segment_stats(seg)
                 for name, seg in partition.nuc_sequences.items()}
                for partition in self.partitions
            ]
        return self._roaring_stats

    def info(self) -> dict:
        """/info — reference-exact (database.cpp getDatabaseInfo): totalSize
        sums non-portable Roaring sizes over every nucleotide position
        bitmap; nBitmapsSize over the per-sequence missing-symbol bitmaps.
        Pinned byte-for-byte by endToEndTests/test/info.test.js."""
        stats = self._nuc_roaring_stats()
        return {
            "sequenceCount": sum(p.sequence_count for p in self.partitions),
            "totalSize": sum(st.total_nonportable
                             for per in stats for st in per.values()),
            "nBitmapsSize": sum(st.missing_nonportable_total
                                for per in stats for st in per.values()),
        }

    def detailed_info(self) -> dict:
        """/info?details=true — reference-exact (info_handler.cpp:18-71,
        database.cpp detailedDatabaseInfo): Roaring-model portable sizes
        per symbol and container census for the literal "main" nucleotide
        store (the reference serializes `sequences.at("main")` only).
        Pinned byte-for-byte by endToEndTests/test/info.test.js.

        Faithfully replicated quirks:
        - no "main" store -> error (reference: std::out_of_range -> 500);
        - sizePerGenomeSymbolAndSection has keys "-", "N", "NOT_N_NOT_GAP",
          but GAP bitset containers are recorded under a "GAP" key that the
          constructor never creates (database.cpp:257-323), so the "-"
          array is always zero and a GAP bitset container raises (-> 500).
        """
        import numpy as np

        if "main" not in self.nuc_sequences:
            # reference: DetailedDatabaseInfo::sequences.at("main") throws
            # std::out_of_range whose what() is libstdc++'s "map::at" —
            # the HTTP 500 body carries that exact message
            raise _MapAtError("main")
        section_length = 500
        length = len(self.nuc_sequences["main"])
        n_sections = length // section_length + 1

        mains = [per["main"] for per in self._nuc_roaring_stats()
                 if "main" in per]
        from ..common.symbols import NUCLEOTIDE

        per_symbol = {c: 0 for c in NUCLEOTIDE.chars}
        census = {
            "numberOfArrayContainers": 0,
            "numberOfRunContainers": 0,
            "numberOfBitsetContainers": 0,
            "numberOfValuesStoredInArrayContainers": 0,
            "numberOfValuesStoredInRunContainers": 0,
            "numberOfValuesStoredInBitsetContainers": 0,
            "totalBitmapSizeArrayContainers": 0,
            "totalBitmapSizeRunContainers": 0,
            "totalBitmapSizeBitsetContainers": 0,
        }
        frozen_total = 0
        computed_total = 0
        bitset_missing = np.zeros(length, dtype=np.int64)
        bitset_other = np.zeros(length, dtype=np.int64)
        for st in mains:
            for i, c in enumerate(NUCLEOTIDE.chars):
                per_symbol[c] += int(st.per_symbol_portable[i])
            for key in census:
                census[key] += st.census[key]
            frozen_total += st.frozen_total
            computed_total += st.portable_total
            if st.bitset_gap.any():
                # reference bug (database.cpp:291): the GAP branch does
                # size_per_genome_symbol_and_section.at("GAP") on a map the
                # constructor (database.cpp:153-158) only gave keys
                # {"-", "N", "NOT_N_NOT_GAP"} — std::out_of_range with
                # what() == "map::at" -> HTTP 500. Pinned by
                # test_info_parity.test_gap_bitset_container_500 on a
                # >4096-gap corpus (a real bitset container).
                raise _MapAtError("GAP")
            bitset_missing += st.bitset_missing
            bitset_other += st.bitset_other

        sections = np.arange(length) // section_length

        def per_section(arr):
            return np.bincount(sections, weights=arr,
                               minlength=n_sections).astype(np.int64).tolist()

        return {
            "bitmapSizePerSymbol": per_symbol,
            "bitmapContainerSizePerGenomeSection": {
                "sectionLength": section_length,
                "sizePerGenomeSymbolAndSection": {
                    "-": [0] * n_sections,
                    "N": per_section(bitset_missing),
                    "NOT_N_NOT_GAP": per_section(bitset_other),
                },
                "bitmapContainerSizeStatistic": census,
                "totalBitmapSizeFrozen": frozen_total,
                "totalBitmapSizeComputed": computed_total,
            },
        }

    def tpu_info(self) -> dict:
        """/info?tpu=true — the TPU-native observability surface (SURVEY
        §5.5): actual dense-analog HBM bytes per segment and partition
        layout, i.e. what the device banks cost, as opposed to the
        reference-compatible Roaring-model numbers in info()."""
        segments = {}
        for partition in self.partitions:
            for name, seg in list(partition.nuc_sequences.items()) + list(
                partition.aa_sequences.items()
            ):
                entry = segments.setdefault(name, {
                    "denseSizeBytes": 0, "compactSizeBytes": 0,
                    "storedRows": 0, "length": seg.length,
                })
                entry["denseSizeBytes"] += seg.size_in_bytes()
                entry["compactSizeBytes"] += seg.store.nbytes()
                entry["storedRows"] += int(len(seg.sym_ids))
        return {
            "sequenceCount": sum(p.sequence_count for p in self.partitions),
            "partitions": len(self.partitions),
            "segments": segments,
        }
