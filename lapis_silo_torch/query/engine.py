"""The query engine.

Parity with reference src/silo/query_engine/query_engine.cpp: parse the JSON
query, compile the filter per partition, evaluate to packed bitsets, hand
them to the action. The port's copy of the JAX package's engine
(``lapis_silo_tpu/query/engine.py``), with its device engine given at
construction instead of built lazily: ``install()`` in the package's
``__init__`` builds the device engine and hands it over. Only the port's
``ProgramTooLarge`` / ``StructureMismatch`` fall back to the host, for that
query only; every other failure raises.
"""

from __future__ import annotations

import json
import logging
import time

from .. import tracing
from ..ops.vm import ProgramTooLarge, StructureMismatch
from . import ast
from .actions import Aggregated, Mutations, parse_action
from .errors import QueryParseError
from .ir import HostEvaluator

performance_logger = logging.getLogger("lapis_silo_torch.performance")

_HOST_FALLBACK = (ProgramTooLarge, StructureMismatch)


class Query:
    def __init__(self, query_string: str):
        def _reject_constant(name):
            # nlohmann rejects NaN/Infinity literals that Python's json
            # accepts by default; force the reference behavior
            raise ValueError(f"invalid constant {name}")

        try:
            data = json.loads(query_string, parse_constant=_reject_constant)
        except ValueError as ex:
            # reference query.cpp:24-26 wraps nlohmann's ex.what(); replicate
            # its exact message text (query/nlohmann_errors.py)
            from .nlohmann_errors import parse_error_message

            message = parse_error_message(query_string) or str(ex)
            raise QueryParseError(
                f"The query was not a valid JSON: {message}") from ex
        if (
            not isinstance(data, dict)
            or not isinstance(data.get("filterExpression"), dict)
            or not isinstance(data.get("action"), dict)
        ):
            raise QueryParseError("Query json must contain filterExpression and action.")
        self.filter = ast.parse_expression(data["filterExpression"])
        self.action = parse_action(data["action"])
        # canonical key for the device engine's lowered-program cache:
        # serving workloads repeat filters, and lowering walks every
        # partition in pure Python
        self.filter_key = json.dumps(
            data["filterExpression"], sort_keys=True, separators=(",", ":"))


class QueryEngine:
    """Executes JSON queries on `database`: on `device_engine` (the port's
    ``ops.device_engine.DeviceEngine``) when one is given and `use_device`
    is true, else on the host evaluator alone (the oracle)."""

    def __init__(self, database, device_engine=None, use_device: bool = True):
        self.database = database
        self._device_engine = device_engine
        self._use_device = use_device and device_engine is not None

    def _evaluate_filter(self, query: Query) -> list:
        """Compile + evaluate the filter -> per-partition packed bitsets."""
        if self._use_device:
            try:
                return self._device_engine.evaluate_compact(query.filter)
            except _HOST_FALLBACK:
                pass  # host fallback for this query only
        db = self.database
        results = []
        for partition in db.partitions:
            node = query.filter.compile(db, partition, ast.NONE)
            results.append(HostEvaluator(partition.sequence_count).evaluate(node))
        return results

    def execute(self, query_string: str) -> dict:
        """The query's result. With tracing on (``tracing.enabled()``) the
        request and its parse are recorded as spans, a count's span rides
        its batcher item, and the request's end may log the summary
        (``Recorder.tick``)."""
        if not tracing.enabled():
            return self._execute(query_string, 0, 0)
        recorder = tracing.RECORDER
        span = recorder.new_id()
        start = time.time_ns()
        try:
            return self._execute(query_string, span, start)
        finally:
            end = time.time_ns()
            recorder.tick(end, recorder.record(tracing.REQUEST, start, end,
                                               span))

    def _execute(self, query_string: str, span: int, start: int) -> dict:
        query = Query(query_string)
        t0 = time.time_ns()
        if span:
            recorder = tracing.RECORDER
            recorder.record(tracing.PARSE, start, t0, recorder.new_id(), span)
        fast = self._try_fast_count(query, span, t0)
        if fast is not None:
            return fast
        bitmaps = self._device_filter_for_mutations(query)
        if bitmaps is None:
            bitmaps = self._evaluate_filter(query)
        t1 = time.time_ns()
        rows = query.action.execute_and_order(self.database, bitmaps)
        t2 = time.time_ns()
        performance_logger.info(
            "filter time [microseconds]: %d, action time [microseconds]: %d",
            (t1 - t0) // 1000,
            (t2 - t1) // 1000,
        )
        return {"queryResult": rows}

    def _device_filter_for_mutations(self, query: Query):
        """Mutations keeps its filter on the device (a DeviceFilter): it
        needs only device reductions."""
        if not (self._use_device and isinstance(query.action, Mutations)):
            return None
        try:
            return self._device_engine.device_filter(query.filter)
        except _HOST_FALLBACK:
            return None

    def _device_rows(self, query: Query, span: int = 0,
                     parsed: int = 0) -> list[dict] | None:
        """Aggregated on the device engine, its rows unsorted and unsliced:
        a count through the micro-batcher, group-by through group_counts.
        None where the host answers: another action, no device engine,
        columns group_counts does not take, or a filter the port's lowering
        refuses. A multi-host partial takes these rows as they are
        (parallel/multihost.py); ``_try_fast_count`` orders and slices.
        `span`: the traced request a count serves, or 0; `parsed`: when
        its parse ended."""
        action = query.action
        if not (self._use_device and isinstance(action, Aggregated)):
            return None
        action.validate_order_by(self.database)
        try:
            if action.group_by_fields:
                groups = self._device_engine.group_counts(
                    query.filter, action.group_by_fields)
                if groups is None:
                    return None
                return action.rows_from_group_counts(self.database, groups)
            return [{"count": self._device_engine.count_coalesced(
                query.filter, key=query.filter_key, span=span,
                parsed=parsed)}]
        except _HOST_FALLBACK:
            return None

    def _try_fast_count(self, query: Query, span: int = 0,
                        parsed: int = 0) -> dict | None:
        """The device rows of ``_device_rows``, ordered and sliced."""
        rows = self._device_rows(query, span, parsed)
        if rows is None:
            return None
        action = query.action
        if action.offset is not None and action.offset >= len(rows):
            return {"queryResult": []}
        action._apply_sort(rows)
        return {"queryResult": action._apply_offset_and_limit(rows)}
