#!/usr/bin/env python3
"""A/B of the port's group-count kernel K9 (`group_counts`) between an
earlier tree of `lapis_silo_torch` and this one, in one process on one
NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> lapis_silo_torch | tar -x -C build/ab/parent
    python3 scripts/torch_groupby_ab.py build/ab/parent

The earlier tree (one whose `group_counts` takes one shard's int32 codes and
a zeroed output, PR 6 to PR 10) is loaded as ``parent_lapis_silo_torch``;
its kernels build into ``build/ab/parent/build/torch_kernels``. Both sides
run on the words and codes of this tree's engine over phase 5's corpus of
`chip_smoke.py` (1,048,576 x 29,903 in 4 partitions): the parent's K9 takes
the codes as int32 (the values of this tree's uint8 codes), once per shard,
and its engine's sum of the shards' [P, G] on the card; this tree's
`group_counts_sharded` takes the uint8 codes, once per card. Every case runs
in the order parent, change, change, parent, and every result of the change
equals the parent's:

  kernel cases at phase 5's shapes (one shard of 32,768 words) and phase
  8a's (4 shards of 8,192 words on one card): by date (G 65) and by age
  (G 1,025: the uint8 codes reach 256 bins of it) over the full filter,
  the smoke's 6% Details filter (ages 40-45) and its one-mutation filter,
  each timed as `queued` (chip_smoke.py's cuda_ms: calls queued behind a
  spin on the card) and `wall` (synchronize, calls, synchronize), with the
  bound from the bytes the new kernel must read (1-byte codes) and at int32
  codes;
  the route: the engine's group-by after the filter's words (K9, the sum,
  the copy to the host, the rows' order and decoding), wall per call, the
  parent's route rebuilt from its wrapper;
  each side's card time by kernel, fill, add and copy (torch.profiler) for
  the date case at both shapes;
  probes of the new kernel's choices at both shapes (date and age over the
  full filter): the first design's merge of equal groups by
  __match_any_sync (csrc/group_counts.cu built with -DK9_MATCH_ANY into
  build/ab/), 128 threads a CTA, twice the words a CTA, the fill it
  removes (a zeroed output from a fill before the launch instead of the
  one the launch before zeroed), and int32 codes against uint8.

The last line is a JSON object of every reading; it is also written to
chiprun_out/groupby_ab.json.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (  # noqa: E402
    bound, cuda_ms, details_queries, mutations_queries, nvidia_smi, wall_ms)
from torch_vm_ab import ORDER, device_split, load_parent  # noqa: E402

DEPLOYMENT = dict(n_rows=1048576, length=29903, n_partitions=4)
N_SHARDS = 4
DEVICE = "cuda"
COLUMNS = (["date"], ["age"])


def log(message: str) -> None:
    print(f"[groupby-ab] {message}", flush=True)


def build_variant(kernels, define: str) -> ctypes.CDLL:
    """csrc/group_counts.cu alone, built with -D`define` into build/ab/, its
    C entry bound as kernels.py binds the library's."""
    out = ROOT / "build" / "ab" / f"libk9_{define}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", f"-D{define}", "-o",
                    str(out), str(kernels.CSRC_DIR / "group_counts.cu")],
                   check=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    lib.lapis_group_counts.argtypes = kernels._SIGNATURES["lapis_group_counts"]
    lib.lapis_group_counts.restype = ctypes.c_int
    return lib


def k9_launch(torch, kernels, lib, words, codes, offsets, part_words,
              n_partitions, n_groups, threads=None, blk=None, fill=False):
    """One K9 launch over shards of one card into a zeroed output, as
    _group_counts_cards makes it but with the threads and words a CTA open;
    `fill`: the output zeroed by a fill before the launch (the parent's
    way), not by the launch before."""
    card = words[0].device
    n_bins = kernels.k9_bins(codes[0].dtype, n_groups)
    widths = tuple(w.shape[0] for w in words)
    blk = blk or kernels.k9_block(sum(widths), n_bins, codes[0].element_size())
    rows, cf, n_ctas = kernels.k9_layout(widths, tuple(offsets), part_words,
                                         blk)
    shape = (n_partitions, n_groups)
    stream = torch.cuda.current_stream(card)
    key = ("probe", card, stream.cuda_stream, shape)
    counts = None if fill else SPARES.pop(key, None)
    if counts is None:
        counts = torch.zeros(shape, dtype=torch.int32, device=card)
    spare = None if fill else torch.empty(shape, dtype=torch.int32,
                                          device=card)
    err = lib.lapis_group_counts(
        kernels.k9_table(words, codes, rows), len(words), cf, n_ctas,
        part_words, blk, threads or kernels.K9_THREADS,
        codes[0].element_size(), n_groups, n_bins, n_partitions,
        counts.data_ptr(), None if spare is None else spare.data_ptr(),
        stream.cuda_stream)
    assert err == 0, err
    if spare is not None:
        SPARES[key] = spare
    return counts


SPARES: dict = {}


def timed(torch, label: str, variants: dict, reps: int = 50) -> dict:
    """Each variant (name -> (side, fn)) queued on the card and wall per
    call, in ORDER; every result equals the first parent variant's."""
    want = next(fn for side, fn in variants.values() if side == "parent")()
    for name, (_side, fn) in variants.items():
        assert torch.equal(fn(), want), f"{label} {name}: results differ"
    out = {name: {"queued": [], "wall": []} for name in variants}
    for side in ORDER:
        for name, (v_side, fn) in variants.items():
            if v_side == side:
                out[name]["queued"].append(cuda_ms(fn, reps))
                out[name]["wall"].append(wall_ms(fn, reps))
    log(f"{label}: " + "; ".join(
        f"{name} queued " + " ".join(f"{t:.4f}" for t in r["queued"])
        + " / wall " + " ".join(f"{t:.4f}" for t in r["wall"]) + " ms"
        for name, r in out.items()))
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        raise SystemExit(__doc__)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = nvidia_smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    device = torch.device(DEVICE)

    import lapis_silo_torch
    from lapis_silo_torch.ops import kernels, reductions
    from lapis_silo_torch.ops.device_engine import group_rows
    from lapis_silo_torch.parallel.shards import reduce_sum
    from lapis_silo_torch.query.engine import Query
    from lapis_silo_torch.testing import synthetic_database

    load_parent(Path(argv[1]).resolve())
    pkernels = importlib.import_module("parent_lapis_silo_torch.ops.kernels")
    lib = kernels.load_library()
    match_any = build_variant(kernels, "K9_MATCH_ANY")
    readings = {"card": card}
    t0 = time.perf_counter()
    db = synthetic_database(**DEPLOYMENT)
    log(f"corpus {DEPLOYMENT} in {time.perf_counter() - t0:.1f} s")
    filters = {"full": {"type": "True"},
               "6%": json.loads(details_queries(db)[1])["filterExpression"],
               "mutation": json.loads(mutations_queries(db)[0])[
                   "filterExpression"]}

    def query(expr):
        return Query(json.dumps({"action": {"type": "Aggregated"},
                                 "filterExpression": expr})).filter

    for label, devices in (("5", None), ("8a", [device] * N_SHARDS)):
        engine = lapis_silo_torch.install(db, device, devices=devices)
        offsets, n_words, n_parts = (engine.shards.offsets, engine.n_words,
                                     engine.n_partitions)
        shape = readings[label] = {}
        for columns in COLUMNS:
            codes8, n_groups, decode = engine.group_codes_for(columns)
            assert {c.dtype for c in codes8} == {torch.uint8}
            codes32 = [c.to(torch.int32) for c in codes8]
            g = next(b for b in engine._GROUP_BUCKETS if b >= n_groups) + 1
            for fname, expr in filters.items():
                flt = query(expr)
                words = engine.evaluate_device(flt)
                n_set = sum(int(reductions.popcount_words(w)) for w in words)

                def parent(words=words, g=g):
                    return reduce_sum([pkernels.group_counts(
                        w, c, o, n_words, n_parts, g)
                        for w, c, o in zip(words, codes32, offsets)], device)

                def change(words=words, g=g):
                    return kernels.group_counts_sharded(
                        words, codes8, offsets, n_words, n_parts, g)

                case = f"{label} {'+'.join(columns)} {fname}"
                out = timed(torch, case, {"parent": ("parent", parent),
                                          "change": ("change", change)})
                n_flat = engine.n_flat_words
                work = {cb: (4 * n_flat + cb * n_set + 4 * n_parts * g,
                             n_flat + n_set) for cb in (1, 4)}
                out["set_bits"] = n_set
                out["bound_ms"] = {f"{cb}-byte codes": bound(*w)[0]
                                   for cb, w in work.items()}
                log(f"{case}: {n_set} set bits, bound "
                    + ", ".join(f"{k} {v:.5f} ms"
                                for k, v in out["bound_ms"].items())
                    + f"; {card}")

                # the route after the filter's words: K9, sum, copy, rows
                def parent_route(words=words, g=g):
                    return group_rows(parent(words, g).cpu().numpy(),
                                      n_groups, decode)

                def change_route(words=words, g=g):
                    return group_rows(change(words, g).cpu().numpy(),
                                      n_groups, decode)

                assert parent_route() == change_route()
                route = {"parent": [], "change": []}
                for side in ORDER:
                    fn = parent_route if side == "parent" else change_route
                    times = []
                    for _ in range(50):
                        t0 = time.perf_counter()
                        fn()
                        times.append((time.perf_counter() - t0) * 1e3)
                    route[side].append(statistics.median(times))
                out["route_ms"] = route
                log(f"{case} route (K9, sum, copy, rows), median wall ms: "
                    + "; ".join(f"{side} " + " ".join(f"{t:.4f}" for t in ts)
                                for side, ts in route.items()))
                if columns == ["date"] and fname == "full":
                    out["split"] = {side: device_split(
                        torch, f"{case} {side}", fn)
                        for side, fn in (("parent", parent),
                                         ("change", change))}
                if fname == "full":
                    out["probes"] = probes(torch, kernels, lib, match_any,
                                           words, codes8, codes32, offsets,
                                           n_words, n_parts, g, change(),
                                           f"{case} probes")
                shape[f"{'+'.join(columns)} {fname}"] = out
        db.device_engine = None
        db._engine = None
        del engine
        torch.cuda.empty_cache()

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "groupby_ab.json").write_text(json.dumps(readings, indent=1))
    print(json.dumps(readings), flush=True)
    return 0


def probes(torch, kernels, lib, match_any, words, codes8, codes32, offsets,
           n_words, n_parts, g, want, label) -> dict:
    """The new kernel's choices, ms on the card (queued), each checked
    against `want`: the first design's __match_any_sync merge, 128 threads
    a CTA, twice the words a CTA (2 quads a thread), a fill before the
    launch instead of the output the launch before zeroed, int32 codes."""
    def run(codes=codes8, variant=lib, **kw):
        return lambda: k9_launch(torch, kernels, variant, words, codes,
                                 offsets, n_words, n_parts, g, **kw)

    blk = kernels.k9_block(sum(w.shape[0] for w in words), 256, 1)
    cases = {"default": run(),
             "__match_any_sync merge": run(variant=match_any),
             "128 threads": run(threads=128),
             f"{2 * blk} words a CTA": run(blk=2 * blk),
             "a fill before the launch": run(fill=True),
             "int32 codes": run(codes=codes32)}
    out = {}
    for name, fn in cases.items():
        assert torch.equal(fn(), want), f"{label} {name}"
        out[name] = cuda_ms(fn, reps=50)
    log(f"{label}, ms on the card: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in out.items()))
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv))
