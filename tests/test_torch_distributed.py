"""The port's ShardedQueryStep across processes against the JAX package's.

Ranks of ``lapis_silo_torch.parallel.distributed_worker`` (or of a rank
script over its ``run_rank``) join one gloo group on the CPU through a
``file://`` rendezvous under the test's tmp_path, each holding its shards of
one flat word axis. Their words, put together in global shard order, the
count and the 64 segment counts equal the JAX ``ShardedQueryStep`` on a
mesh of the same number of virtual CPU devices (tests/conftest.py), the
port's one-process step and, on the reference worker's inputs, the numpy
oracle of tests/test_jax_distributed.py. Every value is an integer or a
word: the tolerance is equality. Each run waits on its ranks with a
deadline; a rank that hangs, or outlives a dead rank by GRACE_S, fails the
test with every rank's output. The run on the card is marked `cuda`."""

import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lapis_silo_tpu.ops import device_engine as de
from lapis_silo_tpu.parallel.mesh import ShardedQueryStep as RefStep
from lapis_silo_tpu.parallel.mesh import make_mesh as ref_make_mesh
from lapis_silo_torch.ops import vm
from lapis_silo_torch.ops.device_engine import DeviceEngine
from lapis_silo_torch.ops.words import to_host
from lapis_silo_torch.parallel import distributed, distributed_worker
from lapis_silo_torch.parallel.mesh import ProcessMesh, ShardedQueryStep, make_mesh
from lapis_silo_torch.parallel.shards import gather_words, rank_words, split_words
from lapis_silo_torch.query.engine import Query
from lapis_silo_torch.testing import sample_count_queries, synthetic_database

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
WORKER = "lapis_silo_torch.parallel.distributed_worker"
# a run's deadline: generous, since the ranks start beside other test workers
RUN_TIMEOUT_S = 240
# how long the other ranks may outlive a rank that failed
GRACE_S = 10
# tests/test_torch_mesh.py's corpus: 22 words per partition, padded to 24
# on 4 shards, whose 18-word windows straddle partition edges
CORPUS = dict(n_rows=2048, length=256, n_partitions=3)

# one rank over distributed_worker.run_rank on inputs from an .npz file:
# argv init_method world rank local_shards inputs.npz out.json; writes the
# results per program, or the step's refusal (type, message) and raises it
RANK_SCRIPT = """
import json, sys
import numpy as np, torch
from lapis_silo_torch.parallel import distributed, distributed_worker
from lapis_silo_torch.parallel.mesh import make_mesh
init, world, rank, local, inputs, out = sys.argv[1:]
distributed.initialize(init, int(world), int(rank), torch.device("cpu"))
try:
    data = np.load(inputs)
    mesh = make_mesh([torch.device("cpu")] * int(local))
    try:
        got = [distributed_worker.run_rank(
                   mesh, data[f"code{i}"], data["bank"], data[f"dyn{i}"],
                   data["full"], int(data["start"]))
               for i in range(int(data["n"]))]
    except Exception as e:
        got = {"error": [type(e).__name__, str(e)]}
        raise
    finally:
        with open(out, "w") as f:
            json.dump(got, f)
finally:
    distributed.shutdown()
"""


def _start(tmp_path: Path, argvs: list[list[str]]) -> list:
    """One process per argv (arguments after the interpreter), from the
    repository's root, its output in a log under tmp_path."""
    ranks = []
    for r, argv in enumerate(argvs):
        log = tmp_path / f"rank{r}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, *argv], cwd=REPO,
                                    stdout=f, stderr=subprocess.STDOUT)
        ranks.append((proc, log))
    return ranks


def _outputs(ranks) -> str:
    return "\n".join(f"--- rank {r} (exit {proc.returncode}):\n"
                     f"{log.read_text()[-4000:]}"
                     for r, (proc, log) in enumerate(ranks))


def _wait(ranks, timeout: float = RUN_TIMEOUT_S) -> list[tuple[int, str]]:
    """Every rank's (exit code, output). Fails, after killing the rest,
    when a rank outlives the deadline or a failed rank by GRACE_S."""
    deadline = time.monotonic() + timeout
    failed_at = None
    while any(proc.poll() is None for proc, _ in ranks):
        now = time.monotonic()
        if failed_at is None and any(proc.poll() not in (None, 0)
                                     for proc, _ in ranks):
            failed_at = now
        if now > deadline or (failed_at is not None
                              and now > failed_at + GRACE_S):
            hung = [r for r, (proc, _) in enumerate(ranks)
                    if proc.poll() is None]
            for proc, _ in ranks:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            pytest.fail(f"rank(s) {hung} did not finish:\n{_outputs(ranks)}")
        time.sleep(0.05)
    return [(proc.returncode, log.read_text()) for proc, log in ranks]


def _run_ok(ranks) -> list[str]:
    """Every rank's output; fails unless every rank exited 0."""
    done = _wait(ranks)
    if any(code for code, _ in done):
        pytest.fail(f"a rank failed:\n{_outputs(ranks)}")
    return [out for _, out in done]


def _worker_argvs(tmp_path: Path, world: int, local: int,
                  device: str = "cpu", *extra: str) -> list[list[str]]:
    init = f"file://{tmp_path / 'rendezvous'}"
    return [["-m", WORKER, init, str(world), str(r), "--device", device,
             "--local-shards", str(local), "--out", str(tmp_path / "out"),
             *extra] for r in range(world)]


def _oracle(n_shards: int) -> tuple[np.ndarray, int, int]:
    """tests/test_jax_distributed.py's numpy oracle at D shards: the words,
    the count and the sum of the 64 segment counts."""
    R, PW = 64, 2 * 4 * n_shards
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 1 << 32, size=(R, PW), dtype=np.uint32)
    words = bank[3] & bank[7]
    count = int(np.bitwise_count(words).sum())
    mut = int(np.bitwise_count(bank[0:64] & words[None, :]).sum())
    return words, count, mut


@functools.cache
def _ref_step(n_devices, n_rows, n_dyn, n_words, program_len):
    """The JAX step for these shapes on the first `n_devices` virtual CPU
    devices (one compile for every call)."""
    return RefStep(ref_make_mesh(jax.devices()[:n_devices]), 1, n_rows,
                   n_dyn, n_words, program_len)


def _ref(n_devices, code, bank, dyn, full, seg_slice):
    step = _ref_step(n_devices, bank.shape[0], dyn.shape[0], bank.shape[1],
                     code.shape[1])
    words, count, muts = step(code, bank, dyn, full, seg_slice)
    return np.asarray(words), int(count), np.asarray(muts)


def _one_process(code, bank, dyn, full, seg_slice, n_shards):
    """The port's one-process step on [cpu] * n_shards."""
    devices = [CPU] * n_shards
    step = ShardedQueryStep(devices, bank.shape[1])
    words, count, muts = step(code, split_words(bank, devices),
                              split_words(dyn, devices),
                              split_words(full, devices), seg_slice)
    return to_host(gather_words(words, CPU)), int(count), muts.numpy()


def _ranks_json(tmp_path: Path, world: int) -> list:
    return [json.loads((tmp_path / "out" / f"rank{r}.json").read_text())
            for r in range(world)]


def test_two_ranks_on_the_worker_inputs(tmp_path):
    """2 ranks x 4 CPU shards on scripts/distributed_worker.py's inputs:
    rank 0's RESULT equals the numpy oracle; the ranks' words, in global
    shard order, the JAX step's on the 8 virtual devices; every rank holds
    the same count and segment counts and ran the sharded wrappers once
    (their plain versions, on the CPU)."""
    outs = _run_ok(_start(tmp_path, _worker_argvs(tmp_path, 2, 4)))
    words, count, mut = _oracle(8)
    assert f"RESULT count={count} mut={mut}" in outs[0], outs[0]
    assert "RESULT" not in outs[1]
    ranks = _ranks_json(tmp_path, 2)
    got_words = np.array(ranks[0]["words"] + ranks[1]["words"],
                         dtype=np.uint32)
    np.testing.assert_array_equal(got_words, words)

    code = de.pack_code_array(
        16, [de.ALU, de.ALU], [3, 7],
        [0 | (de.M_MOVB << 24) | (de.B_BANK << 28),
         0 | (0 << 8) | (de.M_AND << 24) | (de.B_BANK << 28)])
    rng = np.random.default_rng(0)
    bank = rng.integers(0, 1 << 32, size=(64, 64), dtype=np.uint32)
    dyn = np.zeros((1, 64), dtype=np.uint32)
    full = np.full(64, 0xFFFFFFFF, dtype=np.uint32)
    ref_words, ref_count, ref_muts = _ref(8, code, bank, dyn, full, 0)
    np.testing.assert_array_equal(got_words, ref_words)
    for rank in ranks:
        assert (rank["world_size"], rank["n_shards"]) == (2, 8)
        assert rank["backend"] == "gloo"
        assert rank["count"] == ref_count
        assert rank["mutation_counts"] == ref_muts.tolist()
        assert rank["plain"]["vm_run_sharded"] == 1
        assert rank["plain"]["mutation_counts_sharded"] == 1
        assert rank["launches"]["vm_run_sharded"] == 0


@pytest.fixture(scope="module")
def corpus_programs():
    """(bank, full, [(code, dyn)]) of tests/test_torch_mesh.py's corpus on
    a 4-shard engine: uint32/int32 numpy arrays of the flat axis."""
    db = synthetic_database(**CORPUS)
    engine = DeviceEngine(db, CPU, devices=[CPU] * 4)
    bank = to_host(gather_words(engine.banks, CPU))
    full = to_host(gather_words(engine.fulls, CPU))
    programs = []
    for query in sample_count_queries(db, 8, seed=3):
        program = engine.lower(Query(query).filter)[0]
        bucket = next(b for b in vm._LEN_BUCKETS if b >= len(program.opcodes))
        code = vm.pack_code_array(bucket, program.opcodes, program.operands,
                                  program.regspec)
        dyn = np.zeros((max(1, len(program.dyn_rows)), bank.shape[1]),
                       dtype=np.uint32)
        for di, rows in enumerate(program.dyn_rows):
            for pi, row in enumerate(rows):
                start = pi * engine.n_words
                dyn[di, start: start + len(row)] = row
        programs.append((code, dyn))
    return bank, full, programs


def _run_script(tmp_path: Path, world: int, local: int, bank, full,
                programs, start: int) -> list:
    """RANK_SCRIPT's ranks over `programs`; (exit code, output, results)
    per rank."""
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, bank=bank, full=full, start=start, n=len(programs),
             **{f"code{i}": c for i, (c, _) in enumerate(programs)},
             **{f"dyn{i}": d for i, (_, d) in enumerate(programs)})
    init = f"file://{tmp_path / 'rendezvous'}"
    ranks = _start(tmp_path, [
        ["-c", RANK_SCRIPT, init, str(world), str(r), str(local),
         str(inputs), str(tmp_path / f"got{r}.json")] for r in range(world)])
    done = _wait(ranks)
    results = [tmp_path / f"got{r}.json" for r in range(world)]
    missing = [r for r, path in enumerate(results) if not path.exists()]
    if missing:
        pytest.fail(f"rank(s) {missing} wrote no result:\n{_outputs(ranks)}")
    return [(code, out, json.loads(path.read_text()))
            for (code, out), path in zip(done, results)]


@pytest.mark.parametrize("seg_slice", ["unclamped", "clamped"])
def test_four_ranks_equal_the_jax_step(tmp_path, corpus_programs, seg_slice):
    """4 ranks x 1 shard over the corpus' sampled programs: the words in
    global shard order, the count and the segment counts equal the JAX
    step on 4 virtual devices and the port's one-process step on
    [cpu] * 4, the segment start inside the bank and past its end."""
    bank, full, programs = corpus_programs
    start = {"unclamped": bank.shape[0] // 2,
             "clamped": bank.shape[0] + 100}[seg_slice]
    ranks = _run_script(tmp_path, 4, 1, bank, full, programs, start)
    for code, out, _ in ranks:
        assert code == 0, out
    for i, (code, dyn) in enumerate(programs):
        want = _ref(4, code, bank, dyn, full, start)
        one = _one_process(code, bank, dyn, full, start, 4)
        got_words = np.concatenate([np.array(got[i]["words"], dtype=np.uint32)
                                    for _, _, got in ranks])
        for words, count, muts in (want, one):
            np.testing.assert_array_equal(got_words, words)
            for _, _, got in ranks:
                assert got[i]["count"] == count
                assert got[i]["mutation_counts"] == muts.tolist()


def test_refuses_words_not_a_multiple_of_the_shards_on_every_rank(
        tmp_path, corpus_programs):
    """2 ranks x 4 shards (D 8) over 66 words: every rank raises the JAX
    step's ValueError, before any collective, so none hangs."""
    _bank, _full, programs = corpus_programs
    code, _dyn = programs[0]
    with pytest.raises(ValueError) as info:
        _ref_step(8, 64, 1, 66, 16)
    bank = np.zeros((64, 66), dtype=np.uint32)
    dyn, full = np.zeros((1, 66), dtype=np.uint32), np.zeros(66, np.uint32)
    for rc, out, got in _run_script(tmp_path, 2, 4, bank, full,
                                    [(code, dyn)], 0):
        assert rc != 0, out
        assert got == {"error": ["ValueError", str(info.value)]}


def test_refuses_a_sparse_tier_program_on_every_rank(tmp_path,
                                                     corpus_programs):
    """A program reading a B_SPARSE row: every rank raises ValueError with
    the reference's message, before any collective."""
    bank, full, programs = corpus_programs
    _code, dyn = programs[0]
    program = vm._Program()
    program.load(0, vm.B_SPARSE, 0)
    code = vm.pack_code_array(16, program.opcodes, program.operands,
                              program.regspec)
    for rc, out, got in _run_script(tmp_path, 2, 2, bank, full,
                                    [(code, dyn)], 0):
        assert rc != 0, out
        assert got == {"error": [
            "ValueError",
            "ShardedQueryStep cannot execute sparse-tier programs"]}


def test_a_dead_rank_fails_the_run_without_hanging(tmp_path):
    """Rank 1 dies before the rendezvous (a device that does not parse);
    rank 0 waits there until the run kills it GRACE_S later and fails,
    with both ranks' output."""
    argvs = _worker_argvs(tmp_path, 2, 1)
    argvs[1][argvs[1].index("--device") + 1] = "no-such-device"
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"rank\(s\) \[0\]"):
        _run_ok(_start(tmp_path, argvs))
    assert time.monotonic() - t0 < RUN_TIMEOUT_S / 2


def test_the_worker_loads_no_jax_module(tmp_path):
    """A fresh worker (one rank, a group of one) loads no module of jax* or
    lapis_silo_tpu*, and gives the oracle's RESULT; one that finds the JAX
    package loaded raises."""
    (argv,) = _worker_argvs(tmp_path, 1, 4)
    (out,) = _run_ok(_start(tmp_path, [argv]))
    _words, count, mut = _oracle(4)
    assert f"RESULT count={count} mut={mut}" in out
    preloaded = tmp_path / "preloaded"
    preloaded.mkdir()
    (argv,) = _worker_argvs(preloaded, 1, 4)
    ranks = _start(preloaded, [[
        "-c", "import runpy, sys, lapis_silo_tpu; sys.argv = sys.argv[1:]; "
        f"runpy.run_module({WORKER!r}, run_name='__main__')",
        WORKER, *argv[2:]]])
    ((rc, out),) = _wait(ranks)
    assert rc != 0 and "the port loaded ['lapis_silo_tpu']" in out, out


def test_mesh_orders_shards_process_major():
    """Global shard rank * L + l is local device l of `rank`: rank 1 of 2
    with 2 local shards holds shards 2 and 3 of the flat axis, and a mesh
    over no process group is the one-process mesh."""
    words = np.arange(16, dtype=np.uint32)
    mesh = ProcessMesh([CPU, CPU], world_size=2, rank=1)
    assert (mesh.n_shards, mesh.window(16)) == (4, (8, 16))
    got = [to_host(part) for part in rank_words(words, mesh)]
    np.testing.assert_array_equal(got[0], words[8:12])
    np.testing.assert_array_equal(got[1], words[12:16])
    with pytest.raises(ValueError, match="do not split over 4 shards"):
        rank_words(np.zeros(18, dtype=np.uint32), mesh)
    single = make_mesh([CPU] * 4)
    assert (single.world_size, single.rank, single.joined) == (1, 0, False)


def test_a_group_of_one_equals_the_one_process_step(tmp_path,
                                                    corpus_programs):
    """In this process, a gloo group of one rank: the step all-reduces over
    it and gives the one-process step's words, count and segment counts."""
    bank, full, programs = corpus_programs
    code, dyn = programs[1]
    assert distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                                  CPU) == "gloo"
    try:
        mesh = make_mesh([CPU] * 4)
        assert mesh.joined and mesh.world_size == 1
        got = distributed_worker.run_rank(mesh, code, bank, dyn, full, 5)
    finally:
        distributed.shutdown()
    words, count, muts = _one_process(code, bank, dyn, full, 5, 4)
    np.testing.assert_array_equal(np.array(got["words"], np.uint32), words)
    assert (got["count"], got["mutation_counts"]) == (count, muts.tolist())


def test_backend_follows_the_device():
    assert distributed.default_backend(CPU) == "gloo"
    assert distributed.default_backend(torch.device("cuda", 0)) == "nccl"


@pytest.mark.cuda
def test_worker_on_the_card(tmp_path):
    """One rank over NCCL with 4 shards on the first card: the oracle's
    RESULT, and K6 (once for the card's four shards, no K1) and K2
    launched with no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    (argv,) = _worker_argvs(tmp_path, 1, 4, "cuda:0")
    (out,) = _run_ok(_start(tmp_path, [argv]))
    _words, count, mut = _oracle(4)
    assert f"RESULT count={count} mut={mut}" in out
    (rank,) = _ranks_json(tmp_path, 1)
    assert rank["backend"] == "nccl"
    assert rank["launches"]["vm_run_sharded"] == 1
    assert rank["launches"]["vm_run"] == 0
    assert rank["launches"]["mutation_counts"] == 4
    assert not any(rank["plain"].values()), rank["plain"]
