"""The reference's query engine, driving the port's device engine.

``lapis_silo_tpu.query.engine.QueryEngine`` builds its JAX DeviceEngine
lazily, turns its device path off for good on ``ImportError`` or
``NotImplementedError``, and imports the JAX device engine to recognise the
host-fallback exceptions. This subclass overrides the three methods that do
so: the device engine is given at construction, only the port's
``ProgramTooLarge`` / ``StructureMismatch`` fall back to the host (for that
query only, as in the reference), and every other failure raises.
"""

from __future__ import annotations

from lapis_silo_tpu.query import ast
from lapis_silo_tpu.query.actions import Aggregated, Mutations
from lapis_silo_tpu.query.engine import Query
from lapis_silo_tpu.query.engine import QueryEngine as _ReferenceQueryEngine
from lapis_silo_tpu.query.ir import HostEvaluator

from ..ops.vm import ProgramTooLarge, StructureMismatch

_HOST_FALLBACK = (ProgramTooLarge, StructureMismatch)


class QueryEngine(_ReferenceQueryEngine):
    def __init__(self, database, device_engine):
        super().__init__(database, use_device=True)
        self._device_engine = device_engine

    def _evaluate_filter(self, query: Query) -> list:
        """Compile + evaluate the filter -> per-partition packed bitsets."""
        if self._use_device:
            try:
                return self._device_engine.evaluate_compact(query.filter)
            except _HOST_FALLBACK:
                pass
        db = self.database
        results = []
        for partition in db.partitions:
            node = query.filter.compile(db, partition, ast.NONE)
            results.append(HostEvaluator(partition.sequence_count).evaluate(node))
        return results

    def _device_filter_for_mutations(self, query: Query):
        """Mutations keeps its filter on the device (a DeviceFilter)."""
        if not (self._use_device and isinstance(query.action, Mutations)):
            return None
        try:
            return self._device_engine.device_filter(query.filter)
        except _HOST_FALLBACK:
            return None

    def _try_fast_count(self, query: Query) -> dict | None:
        """Aggregated on the device engine: counts without group-by go
        through the micro-batcher; group-by takes the host path while the
        device engine's group_counts returns None."""
        action = query.action
        if not (self._use_device and isinstance(action, Aggregated)):
            return None
        try:
            action.validate_order_by(self.database)
            if action.group_by_fields:
                groups = self._device_engine.group_counts(
                    query.filter, action.group_by_fields)
                if groups is None:
                    return None
                rows = action.rows_from_group_counts(self.database, groups)
            else:
                rows = [{"count": self._device_engine.count_coalesced(
                    query.filter, key=query.filter_key)}]
        except _HOST_FALLBACK:
            return None
        if action.offset is not None and action.offset >= len(rows):
            return {"queryResult": []}
        action._apply_sort(rows)
        return {"queryResult": action._apply_offset_and_limit(rows)}
