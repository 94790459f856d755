"""Multi-host serving: partition shards across hosts, query broadcast,
merged partial results.

The port's copy of ``lapis_silo_tpu/parallel/multihost.py``, importing
neither ``jax`` nor ``lapis_silo_tpu``; its wire frames (``SILOPART1``,
``SILOBATCH1``) and HTTP control plane are the reference's byte for byte, so
a coordinator of either package fans out to workers of either.

- every host holds a subset of partitions (its local Database and the port's
  device engine over its own cards; within a host the words may shard over
  several devices, ``parallel/shards.py``);
- the coordinator broadcasts the query JSON to all hosts (the control
  plane), each host executes its partitions and returns a *partial result*;
- partials merge exactly like the reference merges per-partition results
  (sum of cardinalities, hash-map group merges, count-matrix sums, row
  concatenation in partition order), then ordering/offset/limit apply once
  at the coordinator.

A host's partials take the port's single-host device routes
(``query/engine.py``): a count through the micro-batcher
(``count_coalesced``, K1 with EMIT_COUNT), a group-by through
``group_counts`` (K9) and ``rows_from_group_counts`` with every row,
unsorted and unsliced, and Mutations through ``device_filter`` and
``mutation_counts_many`` (K2, and K3 on a two-tier bank). Only the port's
``ProgramTooLarge`` / ``StructureMismatch`` send a partial to the host.

The control plane is plain HTTP so it works across processes/machines; the
same merge code paths are exercised in-process by the tests.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import install
from ..common.dates import string_to_date
from ..common.symbols import NUCLEOTIDE
from ..query import actions as actions_mod
from ..query.engine import Query, QueryEngine
from ..query.errors import QueryParseError
from ..server.http_server import DatabaseMutex, _make
from ..server.watcher import DatabaseDirectoryWatcher, serving_devices
from ..storage import snapshot as snapshot_mod

# fan-out threads per worker: each in-flight public query holds one per
# worker for the worker's whole answer
FANOUT_DEPTH = 128
# seconds between two polls of a host's data directory (StagedSnapshotWatcher)
# and of every host's versions (FlipController)
POLL_SECONDS = 2.0

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Worker side: execute a query on local partitions, return a partial result.
# ---------------------------------------------------------------------------


def execute_partial(database, query_string: str) -> dict:
    """Run the filter on all local partitions and reduce the action to a
    mergeable partial. The partial carries the host's data version so the
    coordinator can detect (and wait out) a mid-flip inconsistency."""
    partial = _execute_partial(database, query_string)
    partial["dataVersion"] = database.data_version.value
    return partial


def _query_engine(database) -> QueryEngine:
    """The database's query engine: the one ``install`` gave it, else a
    host engine (a database with no device engine)."""
    with database._engine_lock:
        if database._engine is None:
            database._engine = QueryEngine(database)
        return database._engine


def _execute_partial(database, query_string: str) -> dict:
    query = Query(query_string)
    action = query.action
    engine = _query_engine(database)

    if isinstance(action, actions_mod.Aggregated):
        # every row, unsorted and unsliced: merge_partials orders, offsets
        # and limits once at the coordinator
        rows = engine._device_rows(query)
        if rows is None:
            rows = action.execute(database, engine._evaluate_filter(query))
        if action.group_by_fields:
            return {"kind": "groups", "rows": rows}
        return {"kind": "count", "count": int(rows[0]["count"])}
    if isinstance(action, actions_mod.Mutations):
        return _mutations_partial(database, engine, query)
    bitmaps = engine._evaluate_filter(query)
    if isinstance(action, actions_mod.InsertionAggregation):
        rows = action.execute(database, bitmaps)
        return {"kind": "insertion_counts", "rows": rows}
    if isinstance(action, actions_mod.Details):
        action_no_slice = actions_mod.Details(action.fields)
        action_no_slice.order_by_fields = action.order_by_fields
        # workers pre-trim to limit+offset rows when a limit exists
        if action.limit is not None:
            action_no_slice.limit = action.limit + (action.offset or 0)
        rows = action_no_slice.execute_and_order(database, bitmaps)
        return {"kind": "rows_sorted", "rows": rows}
    # Fasta / FastaAligned: rows in partition order
    rows = action.execute(database, bitmaps)
    return {"kind": "rows", "rows": rows}


def _mutations_partial(database, engine: QueryEngine, query: Query) -> dict:
    action = query.action
    stores = database.nuc_sequences if action.alphabet is NUCLEOTIDE \
        else database.aa_sequences
    names = action.sequence_names or sorted(stores.keys())
    for name in names:
        actions_mod.check_query(
            name in stores,
            f"Database does not contain the {action.alphabet.name_lower} sequence "
            f"with name: '{name}'",
        )
    kind = "nuc" if action.alphabet is NUCLEOTIDE else "aa"
    # the filter stays on the device (a DeviceFilter) where it lowers
    bitmaps = engine._device_filter_for_mutations(query)
    if bitmaps is None:
        bitmaps = engine._evaluate_filter(query)
    device_engine = getattr(database, "device_engine", None)
    counts = {}
    if device_engine is not None:
        for name, matrix in device_engine.mutation_counts_many(
                kind, names, bitmaps).items():
            counts[name] = np.asarray(matrix, dtype=np.int64)
        return {"kind": "mutation_counts", "alphabet": kind, "counts": counts}
    for name in names:
        matrix = None
        for partition, words in zip(database.partitions, bitmaps):
            if not words.any():
                continue
            segments = (partition.nuc_sequences if kind == "nuc"
                        else partition.aa_sequences)
            part = segments[name].mutation_counts(words)
            matrix = part if matrix is None else matrix + part
        if matrix is not None:
            counts[name] = np.asarray(matrix, dtype=np.int64)
    return {"kind": "mutation_counts", "alphabet": kind, "counts": counts}


# ---------------------------------------------------------------------------
# Partial wire encoding. Counts/groups/rows are small JSON; a Mutations
# partial is a [symbols, positions] count matrix per segment (~16 x 30k
# int64 for SARS-CoV-2 nuc — tens of MB as JSON text per worker per
# query), so matrices travel as a raw binary frame — a small JSON header
# plus concatenated little-endian array bytes — and the coordinator merge
# is frombuffer + array sum, not JSON.
# ---------------------------------------------------------------------------

_PARTIAL_MAGIC = b"SILOPART1\n"


def encode_partial(partial: dict):
    """dict -> wire payload: binary frame for array-carrying partials,
    the dict itself (JSON-serialized by the server layer) otherwise."""
    if partial.get("kind") != "mutation_counts":
        return partial
    header = {k: v for k, v in partial.items() if k != "counts"}
    arrays = []
    blobs = []
    for name, matrix in partial["counts"].items():
        matrix = np.ascontiguousarray(matrix, dtype=np.int64)
        arrays.append({"name": name, "shape": list(matrix.shape)})
        blobs.append(matrix.tobytes())
    header["arrays"] = arrays
    head = json.dumps(header).encode("utf-8")
    return b"".join([_PARTIAL_MAGIC, len(head).to_bytes(4, "little"), head]
                    + blobs)


def decode_partial(raw: bytes) -> dict:
    """Wire payload -> dict (array partials come back as np.int64)."""
    if not raw.startswith(_PARTIAL_MAGIC):
        return json.loads(raw)
    off = len(_PARTIAL_MAGIC)
    head_len = int.from_bytes(raw[off : off + 4], "little")
    off += 4
    partial = json.loads(raw[off : off + head_len])
    off += head_len
    counts = {}
    for desc in partial.pop("arrays"):
        n = int(np.prod(desc["shape"]))
        counts[desc["name"]] = np.frombuffer(
            raw, dtype=np.int64, count=n, offset=off).reshape(desc["shape"])
        off += n * 8
    partial["counts"] = counts
    return partial


# Batched fan-out frame (/internal/partial_batch): the coordinator
# coalesces concurrent public queries into ONE request per worker, so the
# per-query control-plane cost (HTTP routing + dispatch on both sides)
# divides by the batch width.
# Body: JSON array of query strings. Response: SILOBATCH1 frame of
# per-query items, each `u16 status + u32 len + payload` where payload is
# a JSON body (errors included) or a SILOPART binary partial.
_BATCH_MAGIC = b"SILOBATCH1\n"


def encode_partial_batch(items: list[tuple[int, object]]) -> bytes:
    """items: (status, payload dict|bytes) per query, in request order."""
    chunks = [_BATCH_MAGIC, len(items).to_bytes(4, "little")]
    for status, payload in items:
        if not isinstance(payload, (bytes, bytearray)):
            payload = json.dumps(payload).encode("utf-8")
        chunks.append(status.to_bytes(2, "little"))
        chunks.append(len(payload).to_bytes(4, "little"))
        chunks.append(bytes(payload))
    return b"".join(chunks)


def decode_partial_batch(raw: bytes) -> list[tuple[int, bytes]]:
    assert raw.startswith(_BATCH_MAGIC), raw[:16]
    off = len(_BATCH_MAGIC)
    n = int.from_bytes(raw[off : off + 4], "little")
    off += 4
    items = []
    for _ in range(n):
        status = int.from_bytes(raw[off : off + 2], "little")
        length = int.from_bytes(raw[off + 2 : off + 6], "little")
        off += 6
        items.append((status, raw[off : off + length]))
        off += length
    return items


def execute_partial_batch(database, queries: list[str]) -> bytes:
    """Worker side of the batched fan-out: each query executes
    independently; per-query errors travel as per-item statuses so one
    bad query cannot poison its batch-mates."""
    items: list[tuple[int, object]] = []
    for query in queries:
        try:
            items.append((200, encode_partial(
                execute_partial(database, query))))
        except QueryParseError as ex:
            items.append((400, {"error": "Bad request", "message": str(ex)}))
        except Exception as ex:  # noqa: BLE001 — keep serving
            items.append((500, {"error": "Internal server error",
                                "message": str(ex)}))
    return encode_partial_batch(items)


# ---------------------------------------------------------------------------
# Coordinator side: merge partials, apply ordering/slicing once.
# ---------------------------------------------------------------------------


def merge_partials(database, query_string: str, partials: list[dict]) -> dict:
    """`database` is the coordinator's schema context (config + reference
    genomes; it may also own local partitions, in which case its own partial
    is simply one of `partials`)."""
    query = Query(query_string)
    action = query.action
    action.validate_order_by(database)
    kind = partials[0]["kind"] if partials else "rows"

    if kind == "count":
        rows = [{"count": sum(p["count"] for p in partials)}]
    elif kind == "groups":
        merged: dict[tuple, dict] = {}
        for partial in partials:
            for row in partial["rows"]:
                key = tuple(sorted(
                    ((k, v) for k, v in row.items() if k != "count"),
                    key=lambda kv: kv[0],
                ))
                if key in merged:
                    merged[key]["count"] += row["count"]
                else:
                    merged[key] = dict(row)
        rows = list(merged.values())
    elif kind == "mutation_counts":
        rows = _merge_mutations(database, action, partials)
    elif kind == "insertion_counts":
        merged = {}
        for partial in partials:
            for row in partial["rows"]:
                key = (row["sequenceName"], row["position"], row["insertions"])
                if key in merged:
                    merged[key]["count"] += row["count"]
                else:
                    merged[key] = dict(row)
        rows = [merged[k] for k in sorted(merged)]
    elif kind == "rows_sorted":
        rows = _merge_sorted_rows(database, action, partials)
        if action.offset is not None and action.offset >= len(rows):
            return {"queryResult": []}
        return {"queryResult": action._apply_offset_and_limit(rows)}
    else:  # plain rows, partition order == host order
        rows = [row for partial in partials for row in partial["rows"]]
        total_limit = {"Fasta": 10000, "FastaAligned": 10000}.get(
            type(action).__name__)
        if total_limit is not None and len(rows) > total_limit:
            raise QueryParseError(
                f"{type(action).__name__} action currently limited to "
                f"{total_limit} sequences")

    if action.offset is not None and action.offset >= len(rows):
        return {"queryResult": []}
    action._apply_sort(rows)
    return {"queryResult": action._apply_offset_and_limit(rows)}


def _merge_mutations(database, action, partials) -> list[dict]:
    alphabet = action.alphabet
    stores = database.nuc_sequences if alphabet is NUCLEOTIDE else database.aa_sequences
    names = action.sequence_names or sorted(stores.keys())
    out = []
    for name in names:
        total_matrix = None
        for partial in partials:
            if name not in partial["counts"]:
                continue
            matrix = np.asarray(partial["counts"][name], dtype=np.int64)
            total_matrix = matrix if total_matrix is None else total_matrix + matrix
        if total_matrix is None:
            continue
        reference_ids = np.asarray(stores[name])
        valid_ids = np.asarray(alphabet.valid_mutation_ids)
        sub = total_matrix[valid_ids]                      # [S, L]
        totals = sub.sum(axis=0)                           # [L]
        # threshold per position: ceil(total * minProportion) - 1 in
        # float64, exactly the reference's double math
        # (mutations.cpp:185-233); minProportion 0 -> plain count > 0
        if action.min_proportion == 0:
            thresholds = np.zeros_like(totals)
        else:
            thresholds = (np.ceil(totals.astype(np.float64)
                                  * action.min_proportion) - 1).astype(
                totals.dtype)
        mask = (sub > thresholds[None, :]) & (totals[None, :] > 0)
        mask &= valid_ids[:, None] != reference_ids[None, :]
        # row order parity: position-major, then valid-symbol order —
        # transpose before nonzero (row-major walk)
        pos_idx, sym_idx = np.nonzero(mask.T)
        for pos, si in zip(pos_idx.tolist(), sym_idx.tolist()):
            count = int(sub[si, pos])
            out.append({
                "mutation": alphabet.to_char(int(reference_ids[pos]))
                + str(pos + 1) + alphabet.to_char(int(valid_ids[si])),
                "sequenceName": name,
                "proportion": count / int(totals[pos]),
                "count": count,
            })
    return out


def _merge_sorted_rows(database, action, partials) -> list[dict]:
    """k-way merge of per-host typed-sorted Details rows."""
    metadata = action._field_metadata(database)
    by_name = {m.name: m for m in metadata}

    def typed_key(row):
        values = []
        for fld in action.order_by_fields:
            value = row.get(fld.name)
            m = by_name[fld.name]
            ct = m.column_type().value
            if ct == "date":
                values.append(string_to_date(value) if value else 0)
            elif ct == "int":
                values.append(value if value is not None else -(2**31))
            elif ct == "float":
                values.append(float(value) if value is not None else float("nan"))
            else:
                values.append(value if value is not None else "")
        return actions_mod._TypedKey(
            tuple(values), tuple(f.ascending for f in action.order_by_fields))

    lists = [p["rows"] for p in partials]
    if not action.order_by_fields:
        return [row for rows in lists for row in rows]
    cursors = [0] * len(lists)
    merged: list[dict] = []
    cap = (action.limit + (action.offset or 0)) if action.limit is not None else None
    while cap is None or len(merged) < cap:
        best = None
        for li, rows in enumerate(lists):
            if cursors[li] >= len(rows):
                continue
            key = typed_key(rows[cursors[li]])
            if best is None or key < best[0]:
                best = (key, li)
        if best is None:
            break
        merged.append(lists[best[1]][cursors[best[1]]])
        cursors[best[1]] += 1
    return merged


# ---------------------------------------------------------------------------
# HTTP plumbing: worker endpoint + coordinator fan-out.
# ---------------------------------------------------------------------------


class StagedSnapshotWatcher:
    """Phase 1 of the two-phase multi-host version flip (SURVEY §5.3/§2.10:
    all hosts of a slice must start serving a new snapshot version together;
    the reference, being single-node, has no analog). Polls this host's
    data directory like the single-host watcher, but loads the newest
    snapshot into a *staging* slot without serving it; `commit(v)` (phase 2,
    broadcast by the FlipController once every host has v) atomically
    publishes the staged database to the serving mutex. A host that
    restarts simply re-stages the newest snapshot and is re-committed on
    the controller's next poll — that is the failed-host re-load path.

    A staged database carries the port's engine, installed on the devices
    ``serving_devices`` names (every visible card, or SILO_TORCH_DEVICE);
    with neither, staging fails and is logged, and the host keeps what it
    serves."""

    def __init__(self, data_directory: str, mutex):
        self.data_directory = data_directory
        self.mutex = mutex
        self._lock = threading.Lock()
        self._staged: tuple[str, object] | None = None
        self._serving_version = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="silo-staged-watcher")

    def start(self):
        self.check_once()
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(POLL_SECONDS):
            self.check_once()

    def check_once(self):
        try:
            newest = snapshot_mod.find_newest_snapshot(self.data_directory)
            if newest is None:
                return
            version = newest.rstrip("/").rsplit("/", 1)[-1]
            with self._lock:
                staged_version = self._staged[0] if self._staged else ""
                if version <= max(self._serving_version, staged_version):
                    return
            database = snapshot_mod.load_database(newest)
            # the port's engine before anything else, as the single-host
            # watcher installs it (server/watcher.py): a staged database
            # without one would answer every partial on the host. Then the
            # shared pre-live warm-up (the kernels' library, the pool, the
            # /info size model): the coordinator's first /info fan-out and
            # first committed query must not stall on them
            devices = serving_devices()
            install(database, devices[0],
                    devices=devices if len(devices) > 1 else None)
            DatabaseDirectoryWatcher._warmup(database)
            with self._lock:
                self._staged = (version, database)
        except Exception:  # parity: a bad snapshot never kills the host
            logger.exception("staging snapshot failed; keeping current state")

    def versions(self) -> dict:
        with self._lock:
            return {
                "serving": self._serving_version,
                "staged": self._staged[0] if self._staged else "",
            }

    def commit(self, version: str) -> bool:
        with self._lock:
            if version == self._serving_version:
                return True  # idempotent re-commit
            if self._staged is None or self._staged[0] != version:
                return False
            _, database = self._staged
            self.mutex.set_database(database)
            self._serving_version = version
            self._staged = None
            return True


class _FanoutBatcher:
    """Doorbell batching of the Coordinator's worker fan-out — the
    control-plane analog of the device micro-batcher. A caller enqueues
    its query and the first thread to arrive becomes the leader: it
    drains the pending list in groups, issues ONE partial_batch request
    per worker per group, and distributes results; later arrivals park on
    their entry's event and are batched into the NEXT group. A lone query
    degenerates to one request per worker (the pre-batching behavior, on
    the batch endpoint)."""

    MAX_BATCH = 64

    def __init__(self, coordinator):
        self._coord = coordinator
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._leader_running = False

    def gather(self, db, query_string: str) -> list[dict]:
        entry = {"q": query_string, "db": db, "result": None, "error": None,
                 "done": threading.Event()}
        with self._lock:
            self._pending.append(entry)
            leader = not self._leader_running
            if leader:
                self._leader_running = True
        if leader:
            try:
                while True:
                    with self._lock:
                        batch = self._pending[: self.MAX_BATCH]
                        del self._pending[: len(batch)]
                        if not batch:
                            self._leader_running = False
                            break
                    try:
                        # one db snapshot per group: entries racing a flip
                        # get version-checked (and retried) by their own
                        # execute_query loop
                        self._coord._batch_fanout(batch[0]["db"], batch)
                    except Exception as ex:  # noqa: BLE001
                        for e in batch:
                            if e["error"] is None and e["result"] is None:
                                e["error"] = ex
                    finally:
                        for e in batch:
                            e["done"].set()
            except BaseException:
                with self._lock:
                    self._leader_running = False
                raise
        entry["done"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]


class _FixedMutex:
    """get_database() over an immutable database (fixed single-snapshot
    workers, the pre-flip deployment mode)."""

    def __init__(self, database):
        self._database = database

    def get_database(self):
        return self._database


def _worker_router(mutex, watcher):
    """Router of the worker control plane (/internal/*): (status, payload,
    data_version=None) tuples; a binary partial frame is a bytes payload."""

    def route(method: str, target: str, body: bytes):
        path = target.split("?", 1)[0]
        if method == "GET":
            if path == "/internal/info":
                return 200, mutex.get_database().info(), None
            if path == "/internal/detailed_info":
                return 200, mutex.get_database().detailed_info(), None
            if path == "/internal/version":
                if watcher is not None:
                    return 200, watcher.versions(), None
                version = mutex.get_database().data_version.value
                return 200, {"serving": version, "staged": ""}, None
            return 404, {"error": "Not found",
                         "message": f"Resource {path} does not exist"}, None
        if method == "POST":
            if path == "/internal/commit":
                version = json.loads(body)["version"]
                if watcher is not None:
                    committed = watcher.commit(version)
                else:
                    committed = (mutex.get_database().data_version.value
                                 == version)
                return (200 if committed else 409,
                        {"committed": committed}, None)
            if path == "/internal/partial_batch":
                return (200, execute_partial_batch(
                    mutex.get_database(), json.loads(body)), None)
            if path == "/internal/partial":
                try:
                    return (200, encode_partial(execute_partial(
                        mutex.get_database(),
                        body.decode("utf-8", "replace"))), None)
                except QueryParseError as ex:
                    return 400, {"error": "Bad request",
                                 "message": str(ex)}, None
                except Exception as ex:  # noqa: BLE001 — keep serving
                    return 500, {"error": "Internal server error",
                                 "message": str(ex)}, None
        return 404, {"error": "Not found",
                     "message": f"Resource {path} does not exist"}, None

    return route


def _start_worker_server(mutex, watcher, port: int):
    """The control plane on the server ``_make`` picks (the native epoll
    server where its library builds: every public query pays one worker
    round trip per host), serving when this returns."""
    server = _make(None, port, router=_worker_router(mutex, watcher))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def start_worker(database, port: int = 0):
    return _start_worker_server(_FixedMutex(database), None, port)


def start_replicated_worker(data_directory: str, port: int = 0,
                            start_watcher: bool = True):
    """A worker that hot-reloads its shard's snapshots under coordinated
    flips. Returns (server, watcher, mutex); the worker serves an empty
    database until the controller commits the first version."""
    mutex = DatabaseMutex()
    watcher = StagedSnapshotWatcher(data_directory, mutex)
    if start_watcher:
        watcher.start()
    server = _start_worker_server(mutex, watcher, port)
    return server, watcher, mutex


class _WorkerClient:
    """Persistent keep-alive connections to one worker (an http.client
    pool). urllib opened a fresh TCP connection per fan-out request — at
    fan-out rates the handshakes and TIME_WAIT churn tax every public
    query with one round trip's worth of setup per host."""

    def __init__(self, url: str):
        from urllib.parse import urlparse

        parsed = urlparse(url)
        self._host = parsed.hostname
        self._port = parsed.port or 80
        self._pool: list = []
        self._lock = threading.Lock()

    def request(self, method: str, path: str, body: bytes | None = None,
                timeout: float | None = None) -> tuple[int, bytes]:
        """timeout=None blocks indefinitely (a partial may legitimately
        wait out the first build of the kernels on the worker). The
        timeout applies per REQUEST via settimeout, not per pooled
        connection — connections created by
        a short-timeout caller (version polls) are reused by unbounded
        callers and vice versa."""
        import http.client

        with self._lock:
            conn = self._pool.pop() if self._pool else None
        for attempt in (0, 1):
            if conn is None:
                conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=timeout)
            try:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                break
            except (http.client.RemoteDisconnected, http.client.BadStatusLine,
                    ConnectionResetError, BrokenPipeError) as ex:
                # ONLY stale keep-alive failures retry (the server closed
                # the pooled connection between requests). Timeouts and
                # mid-response errors must NOT retry: the worker may have
                # executed the request already.
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                conn = None
                if attempt:
                    raise ex
            except Exception:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001
                    pass
                raise
        with self._lock:
            self._pool.append(conn)
        return status, data


_worker_clients: dict = {}
_worker_clients_lock = threading.Lock()


def _client_for(url: str) -> _WorkerClient:
    with _worker_clients_lock:
        client = _worker_clients.get(url)
        if client is None:
            client = _worker_clients[url] = _WorkerClient(url)
        return client


class FlipController:
    """Phase 2 of the coordinated version flip: polls every host's
    (serving, staged) versions; when all hosts have the SAME newest version
    available, broadcasts commit so the slice flips together. Hosts whose
    newest differs (one shard directory written, another not yet) block the
    flip — queries keep answering from the old consistent version."""

    def __init__(self, worker_urls: list[str],
                 local_watcher: StagedSnapshotWatcher | None = None):
        self.worker_urls = worker_urls
        self.local_watcher = local_watcher
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="silo-flip-controller")

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.wait(POLL_SECONDS):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — keep polling through failures
                logger.exception("flip poll failed")

    def _worker_versions(self, url: str) -> dict:
        status, data = _client_for(url).request("GET", "/internal/version",
                                                timeout=10)
        if status != 200:
            raise RuntimeError(f"version poll failed: HTTP {status}")
        return json.loads(data)

    def _worker_commit(self, url: str, version: str) -> bool:
        status, data = _client_for(url).request(
            "POST", "/internal/commit",
            body=json.dumps({"version": version}).encode())
        if status != 200:
            return False
        return json.loads(data).get("committed", False)

    def check_once(self) -> str | None:
        """One poll: returns the committed version if a flip happened."""
        states = []
        try:
            for url in self.worker_urls:
                states.append(self._worker_versions(url))
        except Exception:  # a host is down: never flip the others without it
            return None
        if self.local_watcher is not None:
            states.append(self.local_watcher.versions())
        if not states:
            return None
        target = min(max(s["serving"], s["staged"]) for s in states)
        if not target or all(s["serving"] == target for s in states):
            return None
        # every host must actually hold the target version
        if any(target not in (s["serving"], s["staged"]) for s in states):
            return None
        ok = all(self._worker_commit(url, target) for url in self.worker_urls)
        if self.local_watcher is not None:
            ok = self.local_watcher.commit(target) and ok
        if not ok:
            logger.warning(
                "partial flip to %s; will re-commit next poll", target)
            return None
        logger.info("slice flipped to version %s", target)
        return target


class Coordinator:
    """Fans a query out to workers (including, optionally, local partitions)
    and merges partials. Worker errors propagate: a 400 re-raises as
    QueryParseError so the API layer answers exactly like single-host."""

    def __init__(self, database, worker_urls: list[str], include_local: bool = True,
                 flip_retries: int = 5, flip_retry_seconds: float = 0.5):
        # `database` may be a Database or a mutex-like with get_database()
        # (hot-reloading deployments).
        self._database_source = database
        self.worker_urls = worker_urls
        self._include_local_requested = include_local
        self.flip_retries = flip_retries
        self.flip_retry_seconds = flip_retry_seconds
        self._fanout_batcher = _FanoutBatcher(self)
        # Each in-flight PUBLIC query holds one task per worker for the
        # full worker-side duration, and the workers' micro-batch depth
        # equals their concurrently blocked requests — so the pool must
        # cover (target public concurrency) x (workers), not CPUs. Its
        # threads start at the first fan-out.
        self._fanout_executor = ThreadPoolExecutor(
            max_workers=max(1, len(worker_urls)) * FANOUT_DEPTH,
            thread_name_prefix="silo-fanout")

    @property
    def database(self):
        src = self._database_source
        return src.get_database() if hasattr(src, "get_database") else src

    @property
    def include_local(self):
        return self._include_local_requested and bool(self.database.partitions)

    def execute_query(self, query_string: str) -> dict:
        """Fan out + merge; during a version flip hosts may briefly disagree
        on data version — partials are version-checked and the fan-out
        retried until the slice is consistent again."""
        last_error = None
        for _ in range(self.flip_retries):
            # ONE snapshot for the whole attempt: a flip landing between
            # gather and merge must not merge v1 partials with v2 schema
            # context (reference genomes, dictionaries).
            db = self.database
            partials = self._gather_partials(db, query_string)
            versions = {p.get("dataVersion", "") for p in partials}
            if len(versions) <= 1:
                return merge_partials(db, query_string, partials)
            last_error = RuntimeError(
                f"hosts disagree on data version {sorted(versions)}; "
                "flip in progress")
            time.sleep(self.flip_retry_seconds)
        raise last_error

    def _gather_partials(self, db, query_string: str) -> list[dict]:
        return self._fanout_batcher.gather(db, query_string)

    def _batch_fanout(self, db, entries: list[dict]) -> None:
        """One batched fan-out for a group of concurrent public queries:
        ONE /internal/partial_batch request per worker carrying the
        group's DISTINCT query strings (serving traffic repeats filters),
        local partials computed once per distinct query. Fills each
        entry's `result` (host-ordered partial list) or `error`."""
        uniq: dict[str, int] = {}
        order: list[str] = []
        for entry in entries:
            if entry["q"] not in uniq:
                uniq[entry["q"]] = len(order)
                order.append(entry["q"])
        body = json.dumps(order).encode()
        offset = 1 if (self._include_local_requested and db.partitions) else 0
        # per worker: list over unique queries of (status, raw payload)
        worker_items: list[list | None] = [None] * len(self.worker_urls)
        worker_errors: list[Exception | None] = [None] * len(self.worker_urls)

        def fetch(i, url):
            try:
                status, raw = _client_for(url).request(
                    "POST", "/internal/partial_batch", body=body)
                if status != 200:
                    raise RuntimeError(
                        f"worker partial_batch failed: HTTP {status}")
                items = decode_partial_batch(raw)
                if len(items) != len(order):
                    raise RuntimeError(
                        f"worker returned {len(items)} partials "
                        f"for {len(order)} queries")
                worker_items[i] = items
            except Exception as ex:  # noqa: BLE001
                worker_errors[i] = ex

        futures = [self._fanout_executor.submit(fetch, i, url)
                   for i, url in enumerate(self.worker_urls)]
        local_results: list = [None] * len(order)  # dict | Exception
        if offset:
            for qi, query in enumerate(order):
                try:
                    local_results[qi] = execute_partial(db, query)
                except Exception as ex:  # noqa: BLE001
                    local_results[qi] = ex
        for f in futures:
            f.result()

        def item_error(status: int, raw: bytes) -> Exception:
            try:
                payload = json.loads(raw)
            except Exception:  # noqa: BLE001 — non-JSON error body
                payload = {"message": raw.decode(errors="replace")[:500]}
            if status == 400:
                return QueryParseError(payload["message"])
            return RuntimeError(payload.get("message", f"HTTP {status}"))

        for entry in entries:
            qi = uniq[entry["q"]]
            try:
                partials: list[dict] = []
                if offset:
                    local = local_results[qi]
                    if isinstance(local, Exception):
                        raise local
                    partials.append(local)
                for wi in range(len(self.worker_urls)):
                    if worker_errors[wi] is not None:
                        raise worker_errors[wi]
                    status, raw = worker_items[wi][qi]
                    if status != 200:
                        raise item_error(status, raw)
                    partials.append(decode_partial(raw))
                entry["result"] = partials
            except Exception as ex:  # noqa: BLE001
                entry["error"] = ex

    def _worker_get(self, url: str, path: str) -> dict:
        status, data = _client_for(url).request("GET", path)
        if status != 200:
            raise RuntimeError(f"worker {path} failed: HTTP {status}")
        return json.loads(data)

    def info(self) -> dict:
        total = self.database.info() if self.include_local else {
            "sequenceCount": 0, "totalSize": 0, "nBitmapsSize": 0}
        for url in self.worker_urls:
            info = self._worker_get(url, "/internal/info")
            for key in total:
                total[key] += info.get(key, 0)
        return total

    def detailed_info(self) -> dict:
        """/info?details=true across the slice: numeric leaves (byte
        counts, per-section sizes) sum across hosts, structure and string
        leaves are identical everywhere."""
        parts = [self.database.detailed_info()] if self.include_local else []
        for url in self.worker_urls:
            parts.append(self._worker_get(url, "/internal/detailed_info"))
        merged = parts[0]
        for part in parts[1:]:
            merged = _sum_numeric_tree(merged, part)
        return merged


_INVARIANT_INFO_KEYS = {"sectionLength"}  # identical per host, never summed


def _sum_numeric_tree(a, b):
    if isinstance(a, dict):
        return {k: (a[k] if k in _INVARIANT_INFO_KEYS
                    else _sum_numeric_tree(a[k], b[k])) if k in b else a[k]
                for k in a}
    if isinstance(a, list):
        if len(a) != len(b):  # ragged across hosts (different lengths): keep longer
            longer, shorter = (a, b) if len(a) >= len(b) else (b, a)
            return [_sum_numeric_tree(longer[i], shorter[i])
                    if i < len(shorter) else longer[i]
                    for i in range(len(longer))]
        return [_sum_numeric_tree(x, y) for x, y in zip(a, b)]
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return a
    return a + b
