"""The port's group-by on the device against the JAX package's.

The plain group-count (``ops/reductions.group_counts``, the CPU path of
K9, ``csrc/group_counts.cu``) is held to ``_group_counts_jit`` on seeded
words and codes, over whole corpora and over word-shard windows. The port's
``DeviceEngine.group_counts`` on 1, 4 and 8 CPU shards is held to the JAX
engine's on one device, each package serving its own rich synthetic corpus
built from the same seed (pango-lineage, float and insertion columns): the
same rows in the same order, and the same answers through
``execute_query`` as the JAX engine and the port's host oracle. The cases
are those of ``tests/test_device_groupby.py`` (which needs the reference's
test data) on the synthetic schema, the float canonicalisation case, and
the "use the host path" cases (a column kind with no dense code, more than
2^20 groups). Every value is an integer: the tolerance is equality. K9 is
held to its plain version on the card for every code type at the bucket
edges, on one shard and on several of one card (marked `cuda`)."""

import json

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.ops.reductions import _group_counts_jit
from lapis_silo_tpu.query.engine import Query as RefQuery
from lapis_silo_tpu.query.engine import QueryEngine as RefQueryEngine
from lapis_silo_torch.ops import kernels, reductions
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.query.engine import Query, QueryEngine
from lapis_silo_torch.testing import synthetic_database

CPU = torch.device("cpu")
# 3 partitions of 683/683/682 sequences: 22 words each, padded to 24 on 4
# and 8 shards, whose windows straddle partition edges
CORPUS = dict(n_rows=2048, length=200, n_partitions=3, seed=11, rich=True)

CASES = [
    ({"type": "True"}, ["country", "pango_lineage"]),
    ({"type": "True"}, ["date"]),
    ({"type": "NucleotideEquals", "position": 41, "symbol": "T"}, ["age"]),
    ({"type": "True"}, ["qc_value"]),
    ({"type": "HasNucleotideMutation", "position": 7}, ["date", "country"]),
    ({"type": "False"}, ["country"]),
    ({"type": "Not", "child": {"type": "HasNucleotideMutation",
                               "position": 3}}, ["nucleotideInsertions"]),
    ({"type": "IntBetween", "column": "age", "from": 20, "to": 40},
     ["aminoAcidInsertions", "country"]),
    ({"type": "True"}, ["key"]),
]


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


@pytest.fixture(scope="module")
def port_db():
    return synthetic_database(**CORPUS)


@pytest.fixture(scope="module")
def ref_engine():
    return ref_de.DeviceEngine(ref_testing.synthetic_database(**CORPUS),
                               devices=jax.devices()[:1])


@pytest.fixture(scope="module", params=[1, 4, 8], ids=lambda n: f"{n}shards")
def port_engine(request, port_db):
    devices = [CPU] * request.param if request.param > 1 else None
    return DeviceEngine(port_db, CPU, devices=devices)


@pytest.mark.parametrize("n_groups", [65, 1025, 16385])
@pytest.mark.parametrize("n_shards", [1, 3])
def test_plain_group_counts_match_xla(n_groups, n_shards):
    """Random words (all bits set in one word, none in another), codes
    with padding (n_groups) and negative codes, per-window partials summed
    equal to _group_counts_jit over the whole flat axis."""
    rng = np.random.default_rng(n_groups + n_shards)
    n_partitions, part_words = 4, 9
    pw = n_partitions * part_words
    words = rng.integers(0, 1 << 32, size=pw, dtype=np.uint32)
    words[5], words[6] = 0xFFFFFFFF, 0
    codes = rng.integers(0, n_groups + 3, size=(n_partitions, part_words * 32)
                         ).astype(np.int32)
    codes[:, -40:] = n_groups  # padding sequences
    want = np.asarray(_group_counts_jit(jax.numpy.asarray(words),
                                        jax.numpy.asarray(codes), n_groups))
    flat_codes = codes.reshape(-1)
    local = pw // n_shards
    got = sum(reductions.group_counts(
        _t(words[d * local:(d + 1) * local]),
        torch.from_numpy(flat_codes[32 * d * local:32 * (d + 1) * local]),
        d * local, part_words, n_partitions, n_groups).numpy().astype(np.int64)
        for d in range(n_shards))
    np.testing.assert_array_equal(got, want)
    # a negative code counts nowhere, as in the segment sum
    codes[0, :32] = -1
    want = np.asarray(_group_counts_jit(jax.numpy.asarray(words),
                                        jax.numpy.asarray(codes), n_groups))
    got = reductions.group_counts(_t(words), torch.from_numpy(codes.reshape(-1)),
                                  0, part_words, n_partitions, n_groups)
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_counts_wrapper_checks_and_counts():
    words, codes = _t(np.arange(6, dtype=np.uint32)), torch.zeros(192,
                                                                  dtype=torch.int32)
    before = kernels.GROUP_COUNTS.plain_launches
    out = kernels.group_counts(words, codes, 0, 3, 2, 65)
    assert out.shape == (2, 65) and out.dtype == torch.int32
    assert kernels.GROUP_COUNTS.plain_launches == before + 1
    with pytest.raises(ValueError):
        kernels.group_counts(words, codes[:-1], 0, 3, 2, 65)
    with pytest.raises(ValueError):
        kernels.group_counts(words, codes, 1, 3, 2, 65)  # past the axis
    with pytest.raises(ValueError):
        kernels.group_counts(words.to(torch.int64), codes, 0, 3, 2, 65)


@pytest.mark.parametrize("case", CASES, ids=lambda c: ",".join(c[1]))
def test_group_counts_match_jax_engine(port_engine, ref_engine, case):
    filter_json, columns = case
    body = json.dumps({"action": {"type": "Aggregated"},
                       "filterExpression": filter_json})
    got = port_engine.group_counts(Query(body).filter, columns)
    want = ref_engine.group_counts(RefQuery(body).filter, columns)
    assert got is not None and got == want


@pytest.mark.parametrize("case", CASES, ids=lambda c: ",".join(c[1]))
def test_groupby_queries_match_jax_and_host(port_engine, ref_engine, case):
    """Through the query engines, with an order, a limit and an offset on
    one case: the port on its device engine equals the JAX engine and the
    port's host oracle, and the device engine answered."""
    filter_json, columns = case
    action = {"type": "Aggregated", "groupByFields": columns}
    if columns == ["country", "pango_lineage"]:
        action.update(orderByFields=["count"], limit=5, offset=2)
    body = json.dumps({"action": action, "filterExpression": filter_json})
    before = kernels.GROUP_COUNTS.plain_launches
    got = QueryEngine(port_engine.db, port_engine).execute(body)
    assert kernels.GROUP_COUNTS.plain_launches > before
    assert got == RefQueryEngine(ref_engine.db, use_device=True).execute(body)
    assert got == QueryEngine(port_engine.db, use_device=False).execute(body)


def test_group_codes_split_like_the_words(port_engine, ref_engine):
    """The shards' codes, joined, are the reference's combined codes; the
    cache returns the same object."""
    codes_on, n_groups, _decode = port_engine.group_codes_for(
        ["date", "country"])
    ref_codes, ref_groups, _ = ref_engine.group_codes_for(["date", "country"])
    assert n_groups == ref_groups
    assert len(codes_on) == len(port_engine.shards)
    joined = torch.cat(codes_on).numpy().reshape(port_engine.n_partitions, -1)
    want = np.asarray(ref_codes)
    np.testing.assert_array_equal(joined[:, :want.shape[1]], want)
    assert (joined[:, want.shape[1]:] == n_groups).all()  # shard padding
    assert port_engine.group_codes_for(["date", "country"])[0] is codes_on


def test_group_codes_cache_is_bounded(port_engine, ref_engine):
    """A client cycling through more column lists than GROUP_CODES_CACHED
    (both orders of each pair) leaves at most that many lists' codes on
    the devices, the least recent dropped; every answer, a dropped list's
    rebuilt one too, equals the JAX engine's."""
    body = json.dumps({"action": {"type": "Aggregated"},
                       "filterExpression": {"type": "HasNucleotideMutation",
                                            "position": 7}})
    names = ["date", "country", "age", "pango_lineage"]
    lists = [[a, b] for a in names for b in names if a != b]
    bound = port_engine.GROUP_CODES_CACHED
    assert len(lists) > bound
    for columns in lists + lists[:1]:
        got = port_engine.group_counts(Query(body).filter, columns)
        assert got == ref_engine.group_counts(RefQuery(body).filter, columns)
        assert len(port_engine._group_codes) <= bound
    assert list(port_engine._group_codes) == [
        tuple(c) for c in (lists + lists[:1])[-bound:]]


def test_float_groupby_canonicalization():
    """-0.0 merges with 0.0 and all NaNs form ONE null group: the device
    path groups by bit pattern and canonicalizes first."""
    from lapis_silo_torch.config.database_config import Metadata, ValueType
    from lapis_silo_torch.storage.columns import FloatColumnPartition

    db = synthetic_database(n_rows=64, length=128, n_partitions=1)
    col = FloatColumnPartition()
    nan2 = np.frombuffer(np.uint64(0x7FF8000000000001).tobytes(), np.float64)[0]
    col.values = np.array([0.0, -0.0, np.nan, nan2] * 16, dtype=np.float64)
    db.partitions[0].columns["qcf"] = col
    db.config.schema.metadata.append(Metadata("qcf", ValueType.FLOAT))
    q = json.dumps({"filterExpression": {"type": "True"},
                    "action": {"type": "Aggregated", "groupByFields": ["qcf"]}})
    dev = QueryEngine(db, DeviceEngine(db, CPU)).execute(q)
    assert dev == QueryEngine(db, use_device=False).execute(q)
    assert dev == {"queryResult": [{"qcf": 0.0, "count": 32},
                                   {"qcf": None, "count": 32}]}


def test_unsupported_columns_take_the_host_path(port_db):
    """A column kind with no dense code, and more than 2^20 groups, return
    None (cached); the query engine then answers on the host, equal to the
    oracle."""
    engine = DeviceEngine(port_db, CPU)
    body = json.dumps({"action": {"type": "Aggregated"},
                       "filterExpression": {"type": "True"}})
    # 2,048 keys x 27 days x 97 ages > 2^20
    too_many = ["key", "date", "age"]
    assert engine.group_codes_for(too_many) is None
    assert engine.group_counts(Query(body).filter, too_many) is None

    class OddColumn:
        kind = "bool"

    column = port_db.partitions[0].columns["age"]
    try:
        port_db.partitions[0].columns["age"] = OddColumn()
        assert engine.group_counts(Query(body).filter, ["age"]) is None
    finally:
        port_db.partitions[0].columns["age"] = column
    assert engine.group_codes_for(["age"]) is None  # cached as unsupported
    query = json.dumps({"action": {"type": "Aggregated",
                                   "groupByFields": too_many, "limit": 3},
                        "filterExpression": {"type": "True"}})
    before = kernels.GROUP_COUNTS.plain_launches
    assert QueryEngine(port_db, engine).execute(query) == QueryEngine(
        port_db, use_device=False).execute(query)
    assert kernels.GROUP_COUNTS.plain_launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_group_counts_kernel_matches_plain_on_card(cuda_device):
    """K9 against its plain version for every code type (uint8, int16,
    int32) at every bucket edge (G 65, 1,025, 16,385 and 2^20 + 1: the
    ticket, flush and device-memory forms), with padding and negative
    codes, all bits set and all clear, runs of one code (merged lanes), a
    word count that is no multiple of a CTA's block, on one shard, on 3
    shards that straddle partitions (one launch each), on 3 of ragged widths
    and on 4 of one card through group_counts_sharded (one launch)."""
    rng = np.random.default_rng(9)
    for dtype in kernels.CODE_DTYPES:
        info = torch.iinfo(dtype)
        for n_groups in (65, 1025, 16385, (1 << 20) + 1):
            for n_partitions, part_words in ((1, 1), (3, 1111), (4, 8192)):
                pw = n_partitions * part_words
                words = rng.integers(0, 1 << 32, size=pw, dtype=np.uint32)
                words[: pw // 7] = 0xFFFFFFFF
                words[pw // 7: pw // 5] = 0
                codes = rng.integers(max(info.min, -1),
                                     min(info.max, n_groups) + 1,
                                     size=pw * 32)
                codes[: 32 * (pw // 9)] = rng.integers(0, 3)  # one group's run
                codes = torch.from_numpy(codes).to(dtype)
                for n_shards in (1, 3):
                    local = pw // n_shards
                    for d in range(n_shards):
                        args = (_t(words[d * local:(d + 1) * local]).to(cuda_device),
                                codes[32 * d * local:32 * (d + 1) * local
                                      ].to(cuda_device),
                                d * local, part_words, n_partitions, n_groups)
                        got = kernels.group_counts(*args)
                        want = kernels.group_counts_plain(*args)
                        assert torch.equal(got, want), (dtype, n_groups,
                                                        n_partitions, d)
                cuts = [0, pw // 5, pw // 5 + pw // 3 + 1, pw]
                for bounds in (cuts, np.linspace(0, pw, 5).astype(int)):
                    if np.diff(bounds).min() < 1:
                        continue
                    shards = ([_t(words[a:b]).to(cuda_device)
                               for a, b in zip(bounds, bounds[1:])],
                              [codes[32 * a:32 * b].to(cuda_device)
                               for a, b in zip(bounds, bounds[1:])],
                              [int(a) for a in bounds[:-1]])
                    args = (*shards, part_words, n_partitions, n_groups)
                    before = kernels.GROUP_COUNTS.launches
                    got = kernels.group_counts_sharded(*args)
                    assert kernels.GROUP_COUNTS.launches == before + 1
                    want = kernels.group_counts_sharded_plain(*args)
                    assert torch.equal(got, want), (dtype, n_groups,
                                                    len(bounds) - 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_group_counts_kernel_checks_on_card(cuda_device):
    """The card route refuses codes of another type and codes that do not
    start on a 16-byte boundary (K9 loads them in quads)."""
    words = torch.full((4,), -1, dtype=torch.int32, device=cuda_device)
    codes = torch.zeros(4 * 32 + 16, dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.group_counts(words, codes[1:129], 0, 4, 1, 65)
    with pytest.raises(ValueError):
        kernels.group_counts(words, codes[:128].to(torch.int64), 0, 4, 1, 65)
    assert kernels.group_counts(words, codes[16:144], 0, 4, 1, 65)[0, 0] == 128


@pytest.mark.cuda
def test_group_counts_on_card_match_cpu(cuda_device, port_db):
    """The engine on the card (and on 4 shards of it) answers every case as
    the CPU engine does, through K9: one launch per group-by query, on one
    shard and on 4 shards of one card alike, and no plain version."""
    cpu = DeviceEngine(port_db, CPU)
    for devices in (None, [cuda_device] * 4):
        card = DeviceEngine(port_db, cuda_device, devices=devices)
        before = kernels.GROUP_COUNTS.launches
        plain = kernels.GROUP_COUNTS.plain_launches
        for filter_json, columns in CASES:
            body = json.dumps({"action": {"type": "Aggregated"},
                               "filterExpression": filter_json})
            got = card.group_counts(Query(body).filter, columns)
            assert kernels.GROUP_COUNTS.plain_launches == plain
            assert got == cpu.group_counts(Query(body).filter, columns)
            plain = kernels.GROUP_COUNTS.plain_launches
        assert kernels.GROUP_COUNTS.launches == before + len(CASES)
