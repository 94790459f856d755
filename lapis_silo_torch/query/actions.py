"""Query actions: produce JSON rows from per-partition filter bitsets.

Parity with reference src/silo/query_engine/actions/*.cpp — all 8 actions,
exact validation messages, result field names, row emission order, and the
two distinct sort semantics:

- `apply_sort` (Aggregated/Mutations/Insertions): compares the final
  optional<variant<string,int32,double>> values — None sorts first, then by
  variant type rank (string < int < double), then by value
  (reference actions/action.cpp:37-66).
- Details sorts *typed* values (Tuple comparator, tuple.cpp:186-280): dates
  as raw uint32 (null first), floats with NaN null LAST, strings bytewise.
"""

from __future__ import annotations

import json as _json
import math
from dataclasses import dataclass, field

import numpy as np

from ..common.symbols import AMINO_ACID, NUCLEOTIDE
from ..ops import bitset
from ..storage.columns import INT_NULL
from .errors import QueryParseError, check_query


def dump(value) -> str:
    return _json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def is_unsigned(value) -> bool:
    return isinstance(value, int) and not isinstance(value, bool) and value >= 0


@dataclass
class OrderByField:
    name: str
    ascending: bool


def parse_order_by_field(json) -> OrderByField:
    if isinstance(json, str):
        return OrderByField(json, True)
    message = (
        f"The orderByField '{dump(json)}' must be either a string or an object "
        "containing the fields 'field':string and 'order':string, where the value "
        "of order is 'ascending' or 'descending'"
    )
    check_query(
        isinstance(json, dict)
        and "field" in json
        and "order" in json
        and isinstance(json["field"], str)
        and isinstance(json["order"], str),
        message,
    )
    check_query(json["order"] in ("ascending", "descending"), message)
    return OrderByField(json["field"], json["order"] == "ascending")


def _variant_rank(value):
    # C++ variant<string,int32,double> index ordering
    if isinstance(value, str):
        return 0
    if isinstance(value, bool):
        return 1
    if isinstance(value, int):
        return 1
    return 2


def _variant_less(a, b) -> bool:
    # optional<variant> ordering: nullopt < engaged; then type rank; then value
    if a is None:
        return b is not None
    if b is None:
        return False
    ra, rb = _variant_rank(a), _variant_rank(b)
    if ra != rb:
        return ra < rb
    return a < b


class Action:
    def __init__(self):
        self.order_by_fields: list[OrderByField] = []
        self.limit: int | None = None
        self.offset: int | None = None

    # -- overridables --------------------------------------------------------

    def validate_order_by(self, db):
        raise NotImplementedError

    def execute(self, db, bitmaps) -> list[dict]:
        raise NotImplementedError

    def execute_and_order(self, db, bitmaps) -> list[dict]:
        self.validate_order_by(db)
        rows = self.execute(db, bitmaps)
        if self.offset is not None and self.offset >= len(rows):
            return []
        self._apply_sort(rows)
        return self._apply_offset_and_limit(rows)

    # -- shared helpers --------------------------------------------------------

    def _apply_sort(self, rows: list[dict]):
        if not self.order_by_fields:
            return
        import functools

        def equal(v1, v2):
            if v1 is None or v2 is None:
                return v1 is None and v2 is None
            return _variant_rank(v1) == _variant_rank(v2) and v1 == v2

        def cmp(entry1, entry2):
            for fld in self.order_by_fields:
                v1, v2 = entry1.get(fld.name), entry2.get(fld.name)
                if equal(v1, v2):
                    continue
                less = _variant_less(v1, v2)
                if fld.ascending:
                    return -1 if less else 1
                return 1 if less else -1
            return 0

        rows.sort(key=functools.cmp_to_key(cmp))

    def _apply_offset_and_limit(self, rows: list[dict]) -> list[dict]:
        limit = self.limit if self.limit is not None else len(rows)
        offset = self.offset if self.offset is not None else 0
        end = min(limit + offset, len(rows))
        if self.offset is not None and self.offset >= end:
            return []
        return rows[offset:end]


# ---------------------------------------------------------------------------
# Aggregated
# ---------------------------------------------------------------------------


class Aggregated(Action):
    def __init__(self, group_by_fields: list[str]):
        super().__init__()
        self.group_by_fields = group_by_fields

    @classmethod
    def parse(cls, json):
        return cls(json.get("groupByFields", []))

    def _group_by_metadata(self, db):
        out = []
        for field_name in self.group_by_fields:
            metadata = db.config.get_metadata(field_name)
            check_query(
                metadata is not None,
                f"Metadata field '{field_name}' to group by not found",
            )
            out.append(metadata)
        return out

    def validate_order_by(self, db):
        metadata = self._group_by_metadata(db)
        names = {m.name for m in metadata}
        for fld in self.order_by_fields:
            check_query(
                fld.name == "count" or fld.name in names,
                f"The orderByField '{fld.name}' cannot be ordered by, as it does not "
                "appear in the groupByFields.",
            )

    def rows_from_group_counts(self, db, groups) -> list[dict]:
        """Decode DeviceEngine.group_counts output [(raw_code_tuple, count)]
        into result rows (same display conversion as the host path)."""
        metadata = self._group_by_metadata(db)
        columns = db.partitions[0].columns
        from ..common.dates import date_to_string

        def convert(kind, column, raw):
            if kind in ("string", "indexed_string", "indexed_pango_lineage",
                        "nuc_insertion", "aa_insertion"):
                return column.value_at_id(int(raw))
            if kind == "date":
                return date_to_string(int(raw))
            if kind == "int":
                return None if raw == INT_NULL else int(raw)
            return (None if np.isnan(np.int64(raw).view(np.float64))
                    else float(np.int64(raw).view(np.float64)))

        rows = []
        for raw_codes, count in groups:
            row = {}
            for m, raw in zip(metadata, raw_codes):
                row[m.name] = convert(columns[m.name].kind, columns[m.name], raw)
            row["count"] = count
            rows.append(row)
        return rows

    def execute(self, db, bitmaps):
        if not self.group_by_fields:
            count = sum(bitset.popcount(words) for words in bitmaps)
            return [{"count": count}]
        metadata = self._group_by_metadata(db)
        counts: dict[tuple, int] = {}
        for partition, words in zip(db.partitions, bitmaps):
            rows = bitset.to_ids(words, partition.sequence_count)
            if len(rows) == 0:
                continue
            # Vectorized group-by: per-column integer codes (dict ids or raw
            # bit patterns — bit-pattern equality matches the reference's
            # byte-buffer Tuple hashing), combined via np.unique.
            code_columns = []
            decoders = []
            for m in metadata:
                column = partition.columns[m.name]
                kind = column.kind
                if kind in ("string", "indexed_string", "indexed_pango_lineage",
                            "nuc_insertion", "aa_insertion"):
                    code_columns.append(column.ids[rows].astype(np.int64))
                    decoders.append(lambda vid, c=column: c.value_at_id(int(vid)))
                elif kind == "date":
                    code_columns.append(column.values[rows].astype(np.int64))
                    from ..common.dates import date_to_string

                    decoders.append(lambda v: date_to_string(int(v)))
                elif kind == "int":
                    code_columns.append(column.values[rows].astype(np.int64))
                    decoders.append(lambda v: None if v == INT_NULL else int(v))
                elif kind == "float":
                    code_columns.append(column.values[rows].view(np.int64))
                    decoders.append(
                        lambda v: None
                        if np.isnan(np.int64(v).view(np.float64))
                        else float(np.int64(v).view(np.float64))
                    )
                else:
                    raise QueryParseError(f"Cannot group by column {m.name}")
            stacked = np.stack(code_columns, axis=0)  # [k, nsel]
            unique_keys, inverse = np.unique(stacked, axis=1, return_inverse=True)
            group_counts = np.bincount(inverse.ravel())
            for gi in range(unique_keys.shape[1]):
                key = tuple(
                    decoders[ci](unique_keys[ci, gi]) for ci in range(len(metadata))
                )
                counts[key] = counts.get(key, 0) + int(group_counts[gi])
        result = []
        for key, count in counts.items():
            row = {m.name: value for m, value in zip(metadata, key)}
            row["count"] = count
            result.append(row)
        return result


# ---------------------------------------------------------------------------
# Mutations
# ---------------------------------------------------------------------------


class Mutations(Action):
    def __init__(self, alphabet, sequence_names: list[str], min_proportion: float):
        super().__init__()
        self.alphabet = alphabet
        self.sequence_names = sequence_names
        self.min_proportion = min_proportion

    @classmethod
    def parse_typed(cls, json, alphabet):
        check_query(
            "sequenceName" not in json
            or isinstance(json["sequenceName"], (str, list)),
            "Mutations action can have the field sequenceName of type string or an array of "
            "strings, but no other type",
        )
        sequence_names = []
        if isinstance(json.get("sequenceName"), list):
            for child in json["sequenceName"]:
                check_query(
                    isinstance(child, str),
                    "The field sequenceName of Mutations action must have type string or an "
                    "array, if present. Found:" + dump(child),
                )
                sequence_names.append(child)
        elif isinstance(json.get("sequenceName"), str):
            sequence_names.append(json["sequenceName"])
        check_query(
            "minProportion" in json
            and isinstance(json["minProportion"], (int, float))
            and not isinstance(json["minProportion"], bool),
            "Mutations action must contain the field minProportion of type number with limits "
            "[0.0, 1.0]. Only mutations are returned if the proportion of sequences having "
            "this mutation, is at least minProportion",
        )
        min_proportion = float(json["minProportion"])
        if min_proportion < 0 or min_proportion > 1:
            raise QueryParseError(
                "Invalid proportion: minProportion must be in interval [0.0, 1.0]"
            )
        return cls(alphabet, sequence_names, min_proportion)

    def validate_order_by(self, db):
        valid = {"mutation", "proportion", "count"}
        for fld in self.order_by_fields:
            check_query(
                fld.name in valid,
                f"OrderByField {fld.name} is not contained in the result of this operation.",
            )

    def _stores(self, db) -> dict:
        return db.nuc_sequences if self.alphabet is NUCLEOTIDE else db.aa_sequences

    def execute(self, db, bitmaps):
        stores = self._stores(db)
        names_to_evaluate = []
        for name in self.sequence_names:
            check_query(
                name in stores,
                f"Database does not contain the {self.alphabet.name_lower} sequence with "
                f"name: '{name}'",
            )
            names_to_evaluate.append(name)
        if not self.sequence_names:
            names_to_evaluate = sorted(stores.keys())

        kind = "nuc" if self.alphabet is NUCLEOTIDE else "aa"
        device_engine = getattr(db, "device_engine", None)
        device_counts = (
            # fused popcount reductions over the device-resident bank, all
            # segments dispatched up front with overlapped readbacks
            device_engine.mutation_counts_many(kind, names_to_evaluate, bitmaps)
            if device_engine is not None else None
        )
        output: list[dict] = []
        for name in names_to_evaluate:
            reference_ids = stores[name]
            if device_counts is not None:
                counts = device_counts[name]
                if not (counts != 0).any():
                    continue
            else:
                counts = None  # [S, L]
                for partition, words in zip(db.partitions, bitmaps):
                    if not words.any():
                        continue
                    segments = (
                        partition.nuc_sequences
                        if self.alphabet is NUCLEOTIDE
                        else partition.aa_sequences
                    )
                    part_counts = segments[name].mutation_counts(words)
                    counts = part_counts if counts is None else counts + part_counts
                if counts is None:
                    continue
            valid_ids = self.alphabet.valid_mutation_ids
            totals = counts[valid_ids].sum(axis=0)  # [L]
            for pos in np.nonzero(totals > 0)[0]:
                total = int(totals[pos])
                if self.min_proportion == 0:
                    threshold_count = 0
                else:
                    threshold_count = int(math.ceil(total * self.min_proportion) - 1)
                ref_id = int(reference_ids[pos])
                for sym_id in valid_ids:
                    if sym_id == ref_id:
                        continue
                    count = int(counts[sym_id, pos])
                    if count > threshold_count:
                        output.append(
                            {
                                "mutation": (
                                    self.alphabet.to_char(ref_id)
                                    + str(int(pos) + 1)
                                    + self.alphabet.to_char(sym_id)
                                ),
                                "sequenceName": name,
                                "proportion": count / total,
                                "count": count,
                            }
                        )
        return output


# ---------------------------------------------------------------------------
# Details
# ---------------------------------------------------------------------------


class Details(Action):
    def __init__(self, fields: list[str]):
        super().__init__()
        self.fields = fields

    @classmethod
    def parse(cls, json):
        return cls(json.get("fields", []))

    def _field_metadata(self, db):
        if not self.fields:
            return list(db.config.schema.metadata)
        out = []
        for field_name in self.fields:
            metadata = db.config.get_metadata(field_name)
            check_query(metadata is not None, f"Metadata field {field_name} not found.")
            out.append(metadata)
        return out

    def validate_order_by(self, db):
        names = {m.name for m in self._field_metadata(db)}
        for fld in self.order_by_fields:
            check_query(
                fld.name in names,
                f"OrderByField {fld.name} is not contained in the result of this operation.",
            )

    def execute_and_order(self, db, bitmaps):
        self.validate_order_by(db)
        metadata = self._field_metadata(db)

        # Gather selected rows per partition (global concatenation order =
        # partition order, row id ascending — same as produceAllTuples).
        selected: list[tuple[object, np.ndarray]] = []
        for partition, words in zip(db.partitions, bitmaps):
            rows = bitset.to_ids(words, partition.sequence_count)
            selected.append((partition, rows))

        if self.limit is not None:
            keys = self._typed_keys(selected)
            to_produce = self.limit + (self.offset or 0)
            order = _top_k_like_reference(keys, to_produce)
            out_rows = self._materialize_indices(selected, metadata, order)
        else:
            order = self._typed_argsort(selected) if self.order_by_fields else None
            out_rows = self._materialize_indices(selected, metadata, order)
        return self._apply_offset_and_limit(out_rows)

    def _typed_column_array(self, partition, rows, name):
        column = partition.columns[name]
        kind = column.kind
        if kind in ("date", "int"):
            return column.values[rows].astype(np.int64)
        if kind == "float":
            return column.values[rows].astype(np.float64)
        return np.array(
            [v if v is not None else "" for v in column.values_at(rows)], dtype=object
        )

    def _typed_keys(self, selected):
        """Per partition, a list of typed key tuples (one per selected row)
        honoring the orderBy fields (Tuple comparator semantics)."""
        out = []
        for partition, rows in selected:
            columns = [
                (fld.ascending, self._typed_column_array(partition, rows, fld.name))
                for fld in self.order_by_fields
            ]
            keys = [
                _TypedKey(tuple(arr[i] for _, arr in columns),
                          tuple(asc for asc, _ in columns))
                for i in range(len(rows))
            ]
            out.append(keys)
        return out

    def _typed_argsort(self, selected):
        """Stable argsort over the concatenated selection using the typed
        (Tuple) comparator semantics."""
        keys = []
        total = sum(len(rows) for _, rows in selected)
        for fld in reversed(self.order_by_fields):
            parts = [
                self._typed_column_array(partition, rows, fld.name)
                for partition, rows in selected
                if len(rows)
            ]
            if parts and parts[0].dtype == object:
                joined = np.concatenate(parts)
                _, ranks = np.unique(joined, return_inverse=True)
                key = ranks.astype(np.int64)
                if not fld.ascending:
                    key = -key
            else:
                key = (
                    np.concatenate(parts) if parts else np.zeros(total, dtype=np.int64)
                )
                if key.dtype == np.float64:
                    # typed comparator: NaN (null) sorts greatest
                    if fld.ascending:
                        key = np.where(np.isnan(key), np.inf, key)
                    else:
                        key = np.where(np.isnan(key), -np.inf, -key)
                elif not fld.ascending:
                    key = -key
            keys.append(key)
        if not keys:
            return None
        return [("concat", int(i)) for i in np.lexsort(keys)]

    def _materialize_indices(self, selected, metadata, order):
        values_per_part = []
        for partition, rows in selected:
            values = {m.name: partition.columns[m.name].values_at(rows) for m in metadata}
            values_per_part.append(values)

        def row_dict(part_idx, i):
            values = values_per_part[part_idx]
            return {name: values[name][i] for name in values}

        if order is None:
            out = []
            for part_idx, (_, rows) in enumerate(selected):
                out.extend(row_dict(part_idx, i) for i in range(len(rows)))
            return out
        resolved = []
        if order and order[0][0] == "concat":
            # concatenated indexing (full-sort path)
            offsets = []
            acc = 0
            for _, rows in selected:
                offsets.append(acc)
                acc += len(rows)
            for _, flat in order:
                part_idx = 0
                for pi in range(len(selected)):
                    if flat >= offsets[pi]:
                        part_idx = pi
                resolved.append(row_dict(part_idx, flat - offsets[part_idx]))
        else:
            for part_idx, i in order:
                resolved.append(row_dict(part_idx, i))
        return resolved


def _typed_cmp(v1, v2) -> int:
    """Typed field comparison (reference tuple.cpp:160-280). Floats: NaN
    (null) compares greatest; NaN == NaN."""
    if isinstance(v1, float) or isinstance(v2, float):
        n1 = isinstance(v1, float) and math.isnan(v1)
        n2 = isinstance(v2, float) and math.isnan(v2)
        if n1 or n2:
            if n1 and n2:
                return 0
            return 1 if n1 else -1
    if v1 == v2:
        return 0
    return -1 if v1 < v2 else 1


class _TypedKey:
    """Row sort key with per-field ascending flags (Tuple comparator)."""

    __slots__ = ("values", "asc")

    def __init__(self, values, asc):
        self.values = values
        self.asc = asc

    def __lt__(self, other):
        for v1, v2, asc in zip(self.values, other.values, self.asc):
            c = _typed_cmp(v1, v2)
            if c == 0:
                continue
            return c < 0 if asc else c > 0
        return False


class _MaxHeapItem:
    """Inverts comparison so heapq (a min-heap) acts as std::make_heap's
    max-heap over _TypedKey."""

    __slots__ = ("key", "idx")

    def __init__(self, key, idx):
        self.key = key
        self.idx = idx

    def __lt__(self, other):
        return other.key < self.key


def _top_k_like_reference(keys_per_partition, to_produce: int):
    """Faithful replica of produceSortedTuplesWithLimit + mergeSortedTuples
    (reference details.cpp:67-152) INCLUDING its quirk: when a partition has
    more selected rows than `to_produce`, the first overflowing row is
    examined twice against the heap, which can insert it twice and evict an
    extra element — the conformance corpus pins this behavior
    (DetailsOrderByLimit)."""
    import heapq

    per_partition: list[list[tuple[int, int]]] = []
    for part_idx, keys in enumerate(keys_per_partition):
        n = len(keys)
        k = min(n, to_produce)
        held = [_MaxHeapItem(keys[i], i) for i in range(k)]
        if n > k and k > 0:
            heapq.heapify(held)

            def maybe_replace(i):
                if keys[i] < held[0].key:
                    heapq.heapreplace(held, _MaxHeapItem(keys[i], i))

            maybe_replace(k)  # the quirk: row k is examined once here...
            for i in range(k, n):  # ...and again as the loop's first element
                maybe_replace(i)
        items = sorted(((item.key, item.idx) for item in held), key=lambda t: t[0])
        per_partition.append([(part_idx, idx) for _, idx in items])

    # k-way merge of the per-partition sorted lists, first `to_produce` rows
    cursors = [0] * len(per_partition)
    merged: list[tuple[int, int]] = []
    while len(merged) < to_produce:
        best = None
        for pi, lst in enumerate(per_partition):
            if cursors[pi] >= len(lst):
                continue
            part_idx, idx = lst[cursors[pi]]
            key = keys_per_partition[part_idx][idx]
            if best is None or key < best[0]:
                best = (key, pi)
        if best is None:
            break
        _, pi = best
        merged.append(per_partition[pi][cursors[pi]])
        cursors[pi] += 1
    return merged


# ---------------------------------------------------------------------------
# Fasta / FastaAligned
# ---------------------------------------------------------------------------

FASTA_SEQUENCE_LIMIT = 10_000


class Fasta(Action):
    def __init__(self, sequence_names: list[str]):
        super().__init__()
        self.sequence_names = sequence_names

    @classmethod
    def parse(cls, json):
        check_query(
            "sequenceName" in json and isinstance(json["sequenceName"], (str, list)),
            "Fasta action must have the field sequenceName of type string or an array of "
            "strings",
        )
        names = []
        if isinstance(json["sequenceName"], list):
            for child in json["sequenceName"]:
                check_query(
                    isinstance(child, str),
                    "Fasta action must have the field sequenceName of type string or an array "
                    "of strings; while parsing array encountered the element "
                    + dump(child)
                    + " which is not of type string",
                )
                names.append(child)
        else:
            names.append(json["sequenceName"])
        return cls(names)

    def validate_order_by(self, db):
        primary_key = db.config.schema.primary_key
        for fld in self.order_by_fields:
            check_query(
                fld.name == primary_key or fld.name in self.sequence_names,
                "The only fields returned by the Fasta action are "
                + ",".join(self.sequence_names)
                + f" and {primary_key}",
            )

    def execute(self, db, bitmaps):
        for name in self.sequence_names:
            check_query(
                name in db.unaligned_nuc_sequences,
                f"Database does not contain an unaligned sequence with name: '{name}'",
            )
        primary_key = db.config.schema.primary_key
        total = sum(bitset.popcount(words) for words in bitmaps)
        check_query(
            total <= FASTA_SEQUENCE_LIMIT,
            f"Fasta action currently limited to {FASTA_SEQUENCE_LIMIT} sequences",
        )
        out = []
        for pi, (partition, words) in enumerate(zip(db.partitions, bitmaps)):
            rows = bitset.to_ids(words, partition.sequence_count)
            if not len(rows):
                continue
            keys = partition.columns[primary_key].values_at(rows)
            per_name = {
                name: db.unaligned_nuc_sequences[name][pi] for name in self.sequence_names
            }
            for i, row in enumerate(rows):
                entry = {primary_key: keys[i]}
                for name, store in per_name.items():
                    entry[name] = store.get(int(row)) if store is not None else None
                out.append(entry)
        return out


class FastaAligned(Action):
    def __init__(self, sequence_names: list[str]):
        super().__init__()
        self.sequence_names = sequence_names

    @classmethod
    def parse(cls, json):
        check_query(
            "sequenceName" in json and isinstance(json["sequenceName"], (str, list)),
            "FastaAligned action must have the field sequenceName of type string or an array "
            "of strings",
        )
        names = []
        if isinstance(json["sequenceName"], list):
            for child in json["sequenceName"]:
                check_query(
                    isinstance(child, str),
                    "FastaAligned action must have the field sequenceName of type string or "
                    "an array of strings; while parsing array encountered the element "
                    + dump(child)
                    + " which is not of type string",
                )
                names.append(child)
        else:
            names.append(json["sequenceName"])
        return cls(names)

    def validate_order_by(self, db):
        primary_key = db.config.schema.primary_key
        for fld in self.order_by_fields:
            check_query(
                fld.name == primary_key or fld.name in self.sequence_names,
                "The only fields returned by the FastaAligned action are "
                + ",".join(self.sequence_names)
                + f" and {primary_key}",
            )

    def execute(self, db, bitmaps):
        nuc_names, aa_names = [], []
        for name in self.sequence_names:
            check_query(
                name in db.nuc_sequences or name in db.aa_sequences,
                f"Database does not contain a sequence with name: '{name}'",
            )
            (nuc_names if name in db.nuc_sequences else aa_names).append(name)
        total = sum(bitset.popcount(words) for words in bitmaps)
        check_query(total < 10001, "FastaAligned action currently limited to 10000 sequences")
        primary_key = db.config.schema.primary_key
        out = []
        for partition, words in zip(db.partitions, bitmaps):
            rows = bitset.to_ids(words, partition.sequence_count)
            if not len(rows):
                continue
            keys = partition.columns[primary_key].values_at(rows)
            reconstructed = {
                name: partition.nuc_sequences[name].reconstruct_rows(rows)
                for name in nuc_names
            }
            reconstructed.update(
                {
                    name: partition.aa_sequences[name].reconstruct_rows(rows)
                    for name in aa_names
                }
            )
            for i in range(len(rows)):
                entry = {primary_key: keys[i]}
                for name, seqs in reconstructed.items():
                    entry[name] = seqs[i]
                out.append(entry)
        return out


# ---------------------------------------------------------------------------
# Insertions
# ---------------------------------------------------------------------------


class InsertionAggregation(Action):
    def __init__(self, alphabet, column_names: list[str], sequence_names: list[str]):
        super().__init__()
        self.alphabet = alphabet
        self.column_names = column_names
        self.sequence_names = sequence_names

    @classmethod
    def parse_typed(cls, json, alphabet):
        check_query(
            "sequenceName" not in json or isinstance(json["sequenceName"], (str, list)),
            "Insertions action can have the field sequenceName of type string or an array of "
            "strings, but no other type",
        )
        sequence_names = []
        if isinstance(json.get("sequenceName"), list):
            for child in json["sequenceName"]:
                check_query(
                    isinstance(child, str),
                    "The field sequenceName of the Insertions action must have type string or "
                    "an array, if present. Found:" + dump(child),
                )
                sequence_names.append(child)
        elif isinstance(json.get("sequenceName"), str):
            sequence_names.append(json["sequenceName"])
        check_query(
            "column" not in json or isinstance(json["column"], (str, list)),
            "Insertions action can have the field column of type string or an array of "
            "strings, but no other type",
        )
        column_names = []
        if isinstance(json.get("column"), list):
            for child in json["column"]:
                check_query(
                    isinstance(child, str),
                    "The field column of the Insertions action must have type string or an "
                    "array, if present. Found:" + dump(child),
                )
                column_names.append(child)
        elif isinstance(json.get("column"), str):
            column_names.append(json["column"])
        return cls(alphabet, column_names, sequence_names)

    def validate_order_by(self, db):
        valid = {"position", "insertions", "sequenceName", "count"}
        for fld in self.order_by_fields:
            check_query(
                fld.name in valid,
                f"OrderByField {fld.name} is not contained in the result of this operation.",
            )

    def _column_kind(self):
        return "nuc_insertion" if self.alphabet is NUCLEOTIDE else "aa_insertion"

    def execute(self, db, bitmaps):
        kind = self._column_kind()
        # Validate column names against the schema
        schema_columns = {
            m.name
            for m in db.config.schema.metadata
            if m.column_type().value == kind
        }
        for column_name in self.column_names:
            check_query(
                column_name in schema_columns,
                f"The database does not contain the {self.alphabet.name} column "
                f"'{column_name}'",
            )
        all_sequences = (
            db.nuc_sequences.keys() if self.alphabet is NUCLEOTIDE else db.aa_sequences.keys()
        )
        for name in self.sequence_names:
            check_query(
                name in all_sequences,
                f"The database does not contain the {self.alphabet.name} sequence '{name}'",
            )

        # (sequence_name, position, insertion value) -> count
        counts: dict[tuple[str, int, str], int] = {}
        for partition, words in zip(db.partitions, bitmaps):
            if not words.any():
                continue
            mask = bitset.unpack_words(words, partition.sequence_count)
            for column_name, column in sorted(partition.columns.items()):
                if column.kind != kind:
                    continue
                if self.column_names and column_name not in self.column_names:
                    continue
                for sequence_name, index in column.insertion_indexes.items():
                    if self.sequence_names and sequence_name not in self.sequence_names:
                        continue
                    for position, values in index.positions.items():
                        for value, ids in values.items():
                            count = int(mask[ids].sum())
                            if count > 0:
                                key = (sequence_name, position, value)
                                counts[key] = counts.get(key, 0) + count
        out = []
        for (sequence_name, position, value), count in sorted(counts.items()):
            out.append(
                {
                    "position": position,
                    "sequenceName": sequence_name,
                    "insertions": value,
                    "count": count,
                }
            )
        return out


# ---------------------------------------------------------------------------
# Action dispatch
# ---------------------------------------------------------------------------

_ACTION_TYPES = {
    "Aggregated": Aggregated.parse,
    "Mutations": lambda json: Mutations.parse_typed(json, NUCLEOTIDE),
    "AminoAcidMutations": lambda json: Mutations.parse_typed(json, AMINO_ACID),
    "Details": Details.parse,
    "Fasta": Fasta.parse,
    "FastaAligned": FastaAligned.parse,
    "Insertions": lambda json: InsertionAggregation.parse_typed(json, NUCLEOTIDE),
    "AminoAcidInsertions": lambda json: InsertionAggregation.parse_typed(json, AMINO_ACID),
}


def parse_action(json) -> Action:
    check_query(
        isinstance(json, dict) and "type" in json,
        "The field 'type' is required in any action",
    )
    check_query(
        isinstance(json["type"], str),
        "The field 'type' in all actions needs to be a string, but is: " + dump(json["type"]),
    )
    action_type = json["type"]
    parser = _ACTION_TYPES.get(action_type)
    if parser is None:
        raise QueryParseError(f"{action_type} is not a valid action")
    action = parser(json)
    order_by_fields = [parse_order_by_field(f) for f in json.get("orderByFields", [])]
    check_query(
        "limit" not in json or is_unsigned(json["limit"]),
        "If the action contains a limit, it must be a non-negative number",
    )
    check_query(
        "offset" not in json or is_unsigned(json["offset"]),
        "If the action contains an offset, it must be a non-negative number",
    )
    action.order_by_fields = order_by_fields
    action.limit = json.get("limit")
    action.offset = json.get("offset")
    return action
