"""The group-by's card-level route on the CPU: the narrow group codes, the
sharded entry, and K9's work split.

``DeviceEngine.group_codes_for`` stores a column list's codes in the
narrowest type that holds them and the padding code (uint8 up to 255
groups, int16 up to 32,767, else int32); each width's values equal the JAX
engine's int32 codes. ``kernels.group_counts_sharded`` on 3 and 4 CPU shards
of ragged widths that cross partition edges equals ``_group_counts_jit``
for every code type. A numpy emulation of ``csrc/group_counts.cu`` (the
card's shard table, ``kernels.k9_layout`` and ``k9_table``; each CTA's
shard, partition and word range by the kernel's own arithmetic, which
gives exactly the listed split's rows; the bins each below H) covers
every word exactly once, equals the plain version, and fails under three
mutations of the kernel's split. Every value is an integer: the tolerance
is equality."""

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu import testing as ref_testing
from lapis_silo_tpu.ops import device_engine as ref_de
from lapis_silo_tpu.ops.reductions import _group_counts_jit
from lapis_silo_torch.ops import kernels
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.testing import synthetic_database

CPU = torch.device("cpu")
CORPUS = dict(n_rows=2048, length=200, n_partitions=3, seed=11, rich=True)
# column lists on both sides of 255 and of 32,767 groups on CORPUS: 6
# countries, 27 dates, 97 ages, 2,048 keys
LISTS = {("country",): torch.uint8, ("date", "country"): torch.uint8,
         ("date", "age"): torch.int16, ("key", "country"): torch.int16,
         ("key", "date"): torch.int32}


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array).view(np.int32))


@pytest.fixture(scope="module")
def ref_engine():
    return ref_de.DeviceEngine(ref_testing.synthetic_database(**CORPUS),
                               devices=jax.devices()[:1])


@pytest.fixture(scope="module", params=[1, 4], ids=lambda n: f"{n}shards")
def port_engine(request):
    db = synthetic_database(**CORPUS)
    devices = [CPU] * request.param if request.param > 1 else None
    return DeviceEngine(db, CPU, devices=devices)


def test_code_dtype_edges():
    """The padding code n_groups must fit: 255 groups are uint8, 256 int16,
    32,767 int16, 32,768 int32; and the bins each type reaches."""
    assert [kernels.code_dtype(n) for n in (1, 255, 256, 32767, 32768,
                                            1 << 20)] == [
        torch.uint8, torch.uint8, torch.int16, torch.int16, torch.int32,
        torch.int32]
    with pytest.raises(ValueError):
        kernels.code_dtype(1 << 31)
    assert kernels.k9_bins(torch.uint8, 65) == 65
    assert kernels.k9_bins(torch.uint8, 1025) == 256
    assert kernels.k9_bins(torch.int16, (1 << 20) + 1) == 32768
    assert kernels.k9_bins(torch.int32, (1 << 20) + 1) == (1 << 20) + 1


@pytest.mark.parametrize("columns", list(LISTS), ids=",".join)
def test_group_codes_are_narrowest_and_equal_the_reference(
        port_engine, ref_engine, columns):
    """Each shard's codes have the narrowest type for the list's groups and,
    joined, equal the JAX engine's int32 codes (shard padding carries the
    padding code)."""
    codes_on, n_groups, _ = port_engine.group_codes_for(list(columns))
    ref_codes, ref_groups, _ = ref_engine.group_codes_for(list(columns))
    assert n_groups == ref_groups
    assert kernels.code_dtype(n_groups) == LISTS[columns]
    assert {c.dtype for c in codes_on} == {LISTS[columns]}
    joined = torch.cat(codes_on).to(torch.int64).numpy().reshape(
        port_engine.n_partitions, -1)
    want = np.asarray(ref_codes)
    assert want.dtype == np.int32
    np.testing.assert_array_equal(joined[:, :want.shape[1]], want)
    assert (joined[:, want.shape[1]:] == n_groups).all()


def _shards(rng, dtype, bounds, n_partitions, part_words, n_groups):
    """Random words (one word all set, one clear) and `dtype` codes with
    padding (n_groups, where it fits) and, for signed types, negative
    codes over the flat axis; split at `bounds` into CPU shards. Returns
    (words, codes, offsets) per shard and the whole axis as numpy."""
    info = torch.iinfo(dtype)
    pw = n_partitions * part_words
    words = rng.integers(0, 1 << 32, size=pw, dtype=np.uint32)
    words[pw // 2], words[-1] = 0xFFFFFFFF, 0
    codes = rng.integers(max(info.min, -2), min(n_groups + 3, info.max) + 1,
                         size=pw * 32)
    codes[-40:] = min(n_groups, info.max)
    codes = codes.astype(torch.empty(0, dtype=dtype).numpy().dtype)
    shards = ([_t(words[a:b]) for a, b in zip(bounds, bounds[1:])],
              [torch.from_numpy(codes[32 * a:32 * b])
               for a, b in zip(bounds, bounds[1:])],
              [int(a) for a in bounds[:-1]])
    return shards, words, codes


@pytest.mark.parametrize("dtype", kernels.CODE_DTYPES, ids=str)
@pytest.mark.parametrize("bounds", [[0, 10, 17, 36], [0, 5, 14, 27, 36]],
                         ids=["3ragged", "4ragged"])
@pytest.mark.parametrize("n_groups", [65, 1025])
def test_group_counts_sharded_matches_xla(dtype, bounds, n_groups):
    """group_counts_sharded over ragged windows of 4 partitions x 9 words
    equals _group_counts_jit over the whole axis, and ran the plain version
    once per shard."""
    rng = np.random.default_rng(len(bounds) + n_groups)
    shards, words, codes = _shards(rng, dtype, bounds, 4, 9, n_groups)
    want = np.asarray(_group_counts_jit(
        jax.numpy.asarray(words),
        jax.numpy.asarray(codes.astype(np.int32).reshape(4, -1)), n_groups))
    before = kernels.GROUP_COUNTS.plain_launches
    got = kernels.group_counts_sharded(*shards, 9, 4, n_groups)
    assert kernels.GROUP_COUNTS.plain_launches == before + len(bounds) - 1
    assert got.dtype == torch.int32 and got.shape == (4, n_groups)
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_counts_sharded_checks():
    """One entry per shard, one code type across shards, code types only."""
    words = [_t(np.arange(3, dtype=np.uint32)) for _ in range(2)]
    codes = [torch.zeros(96, dtype=torch.uint8) for _ in range(2)]
    assert kernels.group_counts_sharded(words, codes, [0, 3], 3, 2, 65
                                        ).shape == (2, 65)
    with pytest.raises(ValueError):
        kernels.group_counts_sharded(words, codes, [0], 3, 2, 65)
    with pytest.raises(ValueError):
        kernels.group_counts_sharded(
            words, [codes[0], codes[1].to(torch.int16)], [0, 3], 3, 2, 65)
    with pytest.raises(ValueError):
        kernels.group_counts_sharded(
            words, [c.to(torch.int64) for c in codes], [0, 3], 3, 2, 65)
    with pytest.raises(ValueError):
        kernels.group_counts(words[0], codes[0].to(torch.float32), 0, 3, 2, 65)
    with pytest.raises(ValueError):  # past the axis
        kernels.group_counts_sharded(words, codes, [0, 4], 3, 2, 65)


def _k9_split(widths: list, offsets: list, part_words: int,
              n_partitions: int, blk: int) -> np.ndarray:
    """K9's work split over a card's shards, listed (the spec that
    kernels.k9_layout and the kernel's k9_cta follow): int64 [n_ctas, 4],
    per CTA (shard, partition, lo, hi), the shard-local words [lo, hi) (at
    most `blk`) that all lie in the partition. Shard s holds the global words
    [offsets[s], offsets[s] + widths[s]); partition p the global words
    [p * part_words, (p + 1) * part_words). CTAs run shard by shard,
    partition by partition, in word order."""
    rows = []
    for s, (n, off) in enumerate(zip(widths, offsets)):
        p_lo = off // part_words
        p_hi = min(-(-(off + n) // part_words), n_partitions)
        for p in range(p_lo, p_hi):
            a = max(p * part_words - off, 0)
            b = min((p + 1) * part_words - off, n)
            lo = np.arange(a, b, blk, dtype=np.int64)
            rows.append(np.stack([np.full_like(lo, s), np.full_like(lo, p), lo,
                                  np.minimum(lo + blk, b)], axis=1))
    return (np.concatenate(rows) if rows
            else np.zeros((0, 4), dtype=np.int64))


def _k9_cta(table, cta, part_words, blk):
    """csrc/group_counts.cu's k9_cta, line for line: CTA `cta`'s (shard,
    partition, lo, hi) from the card's shard table (k9_table's rows: words
    and codes addresses, then k9_layout's width, words in the first
    partition, first CTA, CTAs in the first partition, first partition) and
    the CTAs of a whole partition."""
    rows, cf = table
    s = 0
    while s + 1 < len(rows) and rows[s + 1][4] <= cta:
        s += 1
    _words, _codes, n, len0, cta_lo, c0, p_lo = rows[s]
    local = cta - cta_lo
    if local < c0:
        return s, p_lo, local * blk, min(local * blk + blk, len0)
    k = local - c0
    q = k // cf
    start = len0 + q * part_words
    lo = start + (k - q * cf) * blk
    return s, p_lo + 1 + q, lo, min(lo + blk, start + part_words, n)


def _card_table(words, codes, offsets, part_words, blk):
    """The card's shard table as the kernel gets it: k9_table's int64 rows
    of 7 and k9_layout's CTAs of a whole partition; and the launch's
    CTAs."""
    rows, cf, n_ctas = kernels.k9_layout(
        tuple(w.shape[0] for w in words), tuple(offsets), part_words, blk)
    flat = list(kernels.k9_table(words, codes, rows))
    return ([tuple(flat[i:i + 7]) for i in range(0, len(flat), 7)], cf), n_ctas


def _k9_emulate(words, codes, offsets, part_words, n_partitions, n_groups,
                cta_run=_k9_cta):
    """csrc/group_counts.cu on the CPU: the launch's CTAs (_k9_split's count
    over the card's shards at k9_block's words a CTA) each find their run
    (`cta_run`, the kernel's k9_cta), take its words and codes from the
    shard table's addresses, bin the set bits' clipped codes into H =
    k9_bins bins (each below H) and add them into counts, which the launch
    finds zeroed. Asserts that every word is covered exactly once and lies
    in its CTA's partition. Returns counts [P, G] int64."""
    n_bins = kernels.k9_bins(codes[0].dtype, n_groups)
    widths = [w.shape[0] for w in words]
    blk = kernels.k9_block(sum(widths), n_bins, codes[0].element_size())
    table, n_ctas = _card_table(words, codes, offsets, part_words, blk)
    assert n_ctas == _k9_split(widths, offsets, part_words,
                                      n_partitions, blk).shape[0]
    covered = [np.zeros(n, dtype=np.int64) for n in widths]
    counts = np.zeros((n_partitions, n_groups), dtype=np.int64)
    for cta in range(n_ctas):
        s, p, lo, hi = cta_run(table, cta, part_words, blk)
        assert 0 <= lo < hi <= widths[s] and hi - lo <= blk
        # the words and codes at the table's addresses
        w, c = words[s], codes[s]
        assert table[0][s][:2] == (w.data_ptr(), c.data_ptr())
        covered[s][lo:hi] += 1
        glob = offsets[s] + np.arange(lo, hi)
        assert (glob // part_words == p).all(), "a word outside its partition"
        bits = ((w[lo:hi].numpy().view(np.uint32)[:, None]
                 >> np.arange(32)) & 1).reshape(-1).astype(bool)
        code = c[32 * lo:32 * hi].to(torch.int64).numpy()
        keep = bits & (code >= 0)
        bins = np.minimum(code[keep], n_groups - 1)
        assert bins.size == 0 or bins.max() < n_bins
        counts[p, :n_bins] += np.bincount(bins, minlength=n_bins)
    for cover in covered:
        assert (cover == 1).all(), "a word not covered exactly once"
    return counts


def _cta_floor(table, cta, part_words, blk):
    """Mutation: the run inside a whole partition found with the CTAs of
    the first partition's piece counted one short."""
    rows, cf = table
    s, p, lo, hi = _k9_cta(table, cta, part_words, blk)
    _words, _codes, n, len0, cta_lo, c0, p_lo = rows[s]
    if cta - cta_lo < c0 or c0 < 1:
        return s, p, lo, hi
    return _k9_cta(([r[:5] + (r[5] - 1,) + r[6:] for r in rows], cf), cta,
                   part_words, blk)


def _cta_same_partition(table, cta, part_words, blk):
    """Mutation: the partitions after the first numbered from p_lo, not
    p_lo + 1."""
    s, p, lo, hi = _k9_cta(table, cta, part_words, blk)
    first = table[0][s][6]
    return s, p - (p > first), lo, hi


def _cta_unclipped(table, cta, part_words, blk):
    """Mutation: a run not cut at its partition's end (it reads into the
    next partition, under this one's index)."""
    s, p, lo, hi = _k9_cta(table, cta, part_words, blk)
    return s, p, lo, min(lo + blk, table[0][s][2])


CASES = [  # (bounds, n_partitions, part_words, dtype, n_groups)
    ([0, 10, 17, 36], 4, 9, torch.uint8, 65),          # ragged shards
    ([0, 333, 700, 1000, 1600], 4, 400, torch.uint8, 1025),  # H 256 < G
    ([0, 20000], 2, 10000, torch.int16, 16385),        # many CTAs, big H
    ([0, 7, 20], 2, 10, torch.int32, (1 << 20) + 1),   # device memory
    ([0, 1, 2, 3], 3, 1, torch.int16, 65),             # a word a CTA
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[3]}-{c[4]}-"
                         f"{len(c[0]) - 1}shards")
def test_k9_emulation_matches_plain(case):
    """The emulated kernel over the host's split equals the plain version
    on shared-memory and device-memory bins."""
    bounds, n_partitions, part_words, dtype, n_groups = case
    rng = np.random.default_rng(n_groups)
    shards, _words, _codes = _shards(rng, dtype, bounds, n_partitions,
                                     part_words, n_groups)
    want = kernels.group_counts_sharded_plain(*shards, part_words,
                                              n_partitions, n_groups)
    got = _k9_emulate(*shards, part_words, n_partitions, n_groups)
    np.testing.assert_array_equal(got, want.numpy())


def test_k9_cta_is_the_split():
    """The kernel's run arithmetic, over every CTA of the launch, gives
    exactly _k9_split's rows, on ragged shards with blocks that do and do
    not divide the partitions."""
    for widths, offsets, part_words, n_partitions in (
            ([10, 7, 19], [0, 10, 17], 9, 4), ([36], [0], 9, 4),
            ([5, 9, 13, 9], [0, 5, 14, 27], 9, 4),
            ([333, 367, 300, 600], [0, 333, 700, 1000], 400, 4)):
        words = [torch.zeros(n, dtype=torch.int32) for n in widths]
        codes = [torch.zeros(32 * n, dtype=torch.uint8) for n in widths]
        for blk in (1, 2, 4, 7, 256):
            split = _k9_split(widths, offsets, part_words,
                                     n_partitions, blk)
            table, n_ctas = _card_table(words, codes, offsets, part_words,
                                        blk)
            runs = [_k9_cta(table, cta, part_words, blk)
                    for cta in range(n_ctas)]
            assert runs == [tuple(int(v) for v in row) for row in split]


@pytest.mark.parametrize("mutant", [_cta_floor, _cta_same_partition,
                                    _cta_unclipped], ids=lambda f: f.__name__)
def test_k9_emulation_catches_a_broken_split(mutant):
    """Each mutation of the kernel's run arithmetic fails the emulation on
    the ragged cases: a word outside its partition, one covered twice or
    not at all, or wrong answers."""
    failed = 0
    for bounds, n_partitions, part_words, dtype, n_groups in CASES[:2]:
        rng = np.random.default_rng(n_groups)
        shards, _words, _codes = _shards(rng, dtype, bounds, n_partitions,
                                         part_words, n_groups)
        want = kernels.group_counts_sharded_plain(
            *shards, part_words, n_partitions, n_groups).numpy()
        try:
            got = _k9_emulate(*shards, part_words, n_partitions, n_groups,
                              cta_run=mutant)
        except (AssertionError, IndexError):
            failed += 1
            continue
        failed += not np.array_equal(got, want)
    assert failed


def test_k9_split_and_block():
    """The split's CTAs: per shard and partition in word order, at most blk
    words each; the block grows with the bins and with the grid's cap."""
    split = _k9_split([10, 7, 19], [0, 10, 17], 9, 4, 4)
    assert split.tolist()[:6] == [[0, 0, 0, 4], [0, 0, 4, 8], [0, 0, 8, 9],
                                  [0, 1, 9, 10], [1, 1, 0, 4], [1, 1, 4, 7]]
    assert (split[:, 3] - split[:, 2]).sum() == 36
    assert _k9_split([0], [0], 9, 4, 4).shape == (0, 4)
    # a quad of codes a thread: 128, 64, 32 words a CTA
    assert kernels.k9_block(32768, 65, 1) == 128
    assert kernels.k9_block(32768, 1025, 2) == 64
    assert kernels.k9_block(32768, 32768, 2) == 1024  # bits >= bins
    assert kernels.k9_block(1 << 24, 65, 1) == 4096  # the grid's cap
    assert kernels.k9_block(32768, (1 << 20) + 1, 4) == 32  # device bins


def test_k9_layout_and_table():
    """A card's shard table: each shard's words and codes addresses, width,
    words in its first partition, first CTA, CTAs in its first partition
    and first partition; the CTAs of a whole partition and of the launch;
    more than K9_MAX_SHARDS shards refused."""
    words = [_t(np.arange(10, dtype=np.uint32)),
             _t(np.arange(7, dtype=np.uint32))]
    codes = [torch.zeros(320, dtype=torch.int16),
             torch.zeros(224, dtype=torch.int16)]
    rows, cf, n_ctas = kernels.k9_layout((10, 7), (0, 10), 9, 4)
    assert rows == ((10, 9, 0, 3, 0), (7, 7, 4, 2, 1)) and cf == 3
    assert n_ctas == _k9_split([10, 7], [0, 10], 9, 2, 4).shape[0]
    assert list(kernels.k9_table(words, codes, rows)) == [
        words[0].data_ptr(), codes[0].data_ptr(), 10, 9, 0, 3, 0,
        words[1].data_ptr(), codes[1].data_ptr(), 7, 7, 4, 2, 1]
    many = kernels.K9_MAX_SHARDS + 1
    with pytest.raises(ValueError):
        kernels.k9_layout((1,) * many, tuple(range(many)), 9, 4)


def test_k9_binding_matches_the_c_entry():
    """kernels._SIGNATURES binds lapis_group_counts with the C entry's
    parameter types, in order (csrc/group_counts.cu; a pointer, an int or
    a long long each)."""
    import ctypes
    import re

    source = (kernels.CSRC_DIR / "group_counts.cu").read_text()
    params = re.search(r'extern "C" int lapis_group_counts\(([^)]*)\)',
                       source)[1].split(",")
    want = [ctypes.POINTER(ctypes.c_longlong) if "long long*" in p
            else ctypes.c_void_p if "*" in p
            else ctypes.c_longlong if "long long" in p else ctypes.c_int
            for p in params]
    assert kernels._SIGNATURES["lapis_group_counts"] == want
