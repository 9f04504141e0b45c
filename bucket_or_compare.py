#!/usr/bin/env python3
"""Time the port's `bucket_or` kernel against an earlier source of
`csrc/bucket_or.cu` and against variants of its own, on one NVIDIA H100.

    git show e45e822:dgraph_tpu_torch/csrc/bucket_or.cu > build/old.cu
    python3 bucket_or_compare.py --old build/old.cu

`--old` is a source with the first design's C interface,
`bucket_or_launch(f, in_nb, out, M, D, W, chunk, stream)` (a block a row,
split rows merged into a zeroed `out`), as at e45e822.
On the 21M-edge graph of `chip_smoke.py`'s BFS plane it prints, each
timing taken in turns within this one process:

- each level at W 768 (level 1 over the full buckets, levels 2-3 over
  the core buckets, frontiers of the digest's densities drawn from a
  seed): the old kernel, this tree's, and this tree's with 8 and 16
  loads in flight a lane (`kSlots`), beside the level's whole-row bound
  and the bound a call summed; then levels 1-2 bucket by bucket, old
  against this tree's, from a flushed L2;
- each level of the reach path at 48 queries (W 2), old against this
  tree's, device time from a flushed L2;
- this tree's kernel with its per-stream split scratch against a
  `torch.zeros` scratch a call, device and host ms a pass.

Every output is checked equal to the old kernel's or the plain
version's. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# the digest's frontier bits at levels 1-3 of chip_smoke.py's batch
LEVEL_BITS = (196_608, 1_009_491, 3_042_012)
SLOT_VARIANTS = {"slots8": (8, 3), "slots16": (16, 2)}


def nvcc_lib(_build, src: str, name: str, work: str) -> subprocess.Popen:
    path = os.path.join(work, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(src)
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             os.path.join(work, f"lib{name}.so"), path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="an earlier csrc/bucket_or.cu (the first design's "
                         "interface)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bucket_or_compare.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dgraph_tpu_torch.bench import bfs
    from dgraph_tpu_torch.ops import _build, kernels
    from dgraph_tpu_torch.ops import bitgraph as bg

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    work = os.path.join(REPO, "build", "bucket_or_compare")
    os.makedirs(work, exist_ok=True)
    with open(args.old) as fh:
        procs = {"old": nvcc_lib(_build, fh.read(), "old", work)}
    with open(_build.CSRC_DIR / "bucket_or.cu") as fh:
        src = fh.read()
    for name, (slots, blocks) in SLOT_VARIANTS.items():
        v = src.replace("constexpr int kSlots = 12;",
                        f"constexpr int kSlots = {slots};")
        v = v.replace("__launch_bounds__(kOrWarps * 32, 3)\nbucket_or_kernel",
                      f"__launch_bounds__(kOrWarps * 32, {blocks})\n"
                      f"bucket_or_kernel")
        if v.count(f"kSlots = {slots};") != 1:
            raise RuntimeError("csrc/bucket_or.cu no longer has kSlots 12")
        procs[name] = nvcc_lib(_build, v, name, work)
    cs.build_kernels(_build, ["bucket_or"])
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    new_lib = kernels.load_library()
    old = ctypes.CDLL(os.path.join(work, "libold.so"))
    old.bucket_or_launch.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    old.bucket_or_launch.restype = ctypes.c_int

    def old_or(f, nb, out=None):
        m, d = nb.shape
        chunk = max(256, -(-d // 65535))
        if d > chunk:
            out.zero_()
        err = old.bucket_or_launch(f.data_ptr(), nb.data_ptr(),
                                   out.data_ptr(), m, d, f.shape[1], chunk,
                                   torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old bucket_or launch: CUDA error {err}")
        return out

    def variant(name):
        lib = ctypes.CDLL(os.path.join(work, f"lib{name}.so"))
        lib.bucket_or_launch.argtypes = new_lib.bucket_or_launch.argtypes
        lib.bucket_or_launch.restype = ctypes.c_int

        def fn(f, nb, out=None):
            kernels.load_library = lambda: lib
            try:
                return kernels.bucket_or(f, nb, out=out)
            finally:
                kernels.load_library = lambda: new_lib
        return fn

    uniq_src, indptr, dst = bfs.make_graph(bfs.N_NODES, bfs.N_EDGES, seed=0)
    badj = bg.build_bitadjacency(bfs.csr_to_dict(uniq_src, indptr, dst),
                                 device=dev)
    core = bg.build_core_adjacency(badj)
    gen = torch.Generator(device=dev).manual_seed(5)
    bits = torch.from_numpy(kernels.WORD_BITS).to(dev)
    flush = torch.empty(64 << 20, dtype=torch.int64, device=dev)

    def frontier(rows, nbits):
        f = torch.zeros((rows + 1, 768), dtype=torch.int32, device=dev)
        r = torch.randint(0, rows, (nbits,), device=dev, generator=gen)
        b = torch.randint(0, 32 * 768, (nbits,), device=dev, generator=gen)
        f[r, b // 32] = bits[b % 32]
        return f

    fns = {"old": old_or, "new": kernels.bucket_or,
           **{k: variant(k) for k in SLOT_VARIANTS}}
    order = ["old", "new", *SLOT_VARIANTS, *reversed(SLOT_VARIANTS), "new",
             "old"]
    levels = [("level 1", badj.n_slots, badj.buckets),
              ("level 2", core.n_core, core.buckets),
              ("level 3", core.n_core, core.buckets)]
    for (label, rows, buckets), nbits in zip(levels, LEVEL_BITS):
        f = frontier(rows, nbits)
        recs = [(b.in_nb, b.offset) for b in buckets]
        times = {k: [] for k in fns}
        outs = {}
        for k in order:
            ms, out = cs.time_level(fns[k], f, recs, cs.KERNEL_REPS)
            times[k].append(round(ms, 4))
            outs.setdefault(k, out)
        if any(not torch.equal(o, outs["old"]) for o in outs.values()):
            raise AssertionError(f"{label}: the kernels disagree")
        print(f"{label} W 768: ms {times}; whole-row bound "
              f"{cs.level_bound_ms(f, recs):.4f} ms, a call summed "
              f"{cs.calls_bound_ms(f, recs):.4f} | {card}", flush=True)
        if label != "level 3":
            for nb, off in recs:
                o = outs["new"][off:off + nb.shape[0]]
                bt = {"old": [], "new": []}
                for k in ("old", "new", "new", "old"):
                    bt[k].append(round(cs.timed_passes(
                        lambda fn=fns[k]: fn(f, nb, out=o), lambda: None,
                        5, flush), 4))
                bound = cs.level_bound_ms(f, [(nb, off)])
                print(f"  {label} bucket M {nb.shape[0]} D {nb.shape[1]}: "
                      f"ms {bt}, bound {bound:.4f}", flush=True)
        del f, outs
        torch.cuda.empty_cache()

    seed_mat = bfs.seed_matrices(uniq_src, 1, cs.REACH_QUERIES)
    seeds = [np.unique(seed_mat[i]) for i in range(cs.REACH_QUERIES)]
    packed = bg.words_to_device(bg.uids_to_bits_batched(badj, seeds), dev)
    fronts = bg.make_bfs_bits_batched(badj, bfs.DEPTH)(packed)
    recs = [(b.in_nb, b.offset) for b in badj.buckets]
    cached = kernels._or_scratch

    def fresh(words, device, stream):
        return torch.zeros(words, dtype=torch.int32, device=device)

    for i, f in enumerate((packed,) + tuple(fronts[:-1])):
        res, outs = {}, {}
        for k in ("old", "new", "fresh", "fresh", "new", "old"):
            kernels._or_scratch = fresh if k == "fresh" else cached
            out = outs.setdefault(k, torch.empty(
                (badj.n_covered, f.shape[1]), dtype=torch.int32, device=dev))
            fn = fns["old" if k == "old" else "new"]

            def one_pass(fn=fn, out=out):
                for nb, off in recs:
                    fn(f, nb, out=out[off:off + nb.shape[0]])

            ms = cs.timed_passes(one_pass, lambda: None, cs.KERNEL_REPS,
                                 flush)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            res.setdefault(k, []).append((round(ms, 4), round(host, 4)))
        kernels._or_scratch = cached
        if any(not torch.equal(o, outs["old"]) for o in outs.values()):
            raise AssertionError(f"reach level {i + 1}: the kernels disagree")
        print(f"reach level {i + 1} W {f.shape[1]}: (device ms, host ms) a "
              f"pass {res}; whole-row bound "
              f"{cs.level_bound_ms(f, recs):.4f} ms | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
