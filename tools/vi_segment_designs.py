#!/usr/bin/env python3
"""Two designs of the SORT2AGGREGATE kernels, ``vi_kernel`` (Algorithm 4,
``src/repro_torch/csrc/vi.cu``) and ``segment_resolve_kernel``
(``csrc/segment_resolve.cu``), on the card at the main path's shapes.

``compare`` builds another copy of the two sources (``--old DIR``: a
directory holding ``vi.cu``, ``segment_resolve.cu`` and the headers they
include, such as a parent commit's ``csrc/`` unpacked by ``git show`` into a
directory that ``.gitignore`` lists) and times it against the package's
build in turns (old, new, new, old; CUDA-event medians), through the
package's wrappers on the same inputs, and requires the same bits:

* ``vi``: simulate (S=1, a 1% sample, 3,140 steps), the per-scenario warm
  start (S=32, a 10% sample, 125,040 steps a lane) and the warm start with
  a per-event overlay (S=8: each lane's rows perturbed, an eligibility
  mask);
* ``segment_resolve``: the S=32 replay at an S2A sweep's cap times, one
  lane, a 125,000-row chunk at offset 375,000 and a 250,000-row shard at
  offset 250,000.

It also prints each design's time launched back to back (the device's
time when the host keeps ahead of it).

``phases`` inserts ``clock64()`` stamps into a copy of the first designs'
sources (``--old DIR``; the anchors are lines of those sources) or, with
``--design new``, of the package's, and prints where a ``vi`` step (per
thread, over every step) and a ``segment_resolve`` tile (per CTA) spend
their cycles, with each build's ``-Xptxas -v`` report; ``--sass DIR`` also
writes ``cuobjdump -sass`` of the builds there. A stamp next to a barrier
can slip past it, so read a phase between two barriers. ``cuts`` times the
package's ``vi`` with parts of a step cut out (the scan, the update, all
but one group a thread, the copies after the first stages, the division)
against the whole kernel; a cut kernel's bits are not checked.

Run from the repository root on a CUDA machine, for example:

    mkdir -p build/old
    for f in vi.cu segment_resolve.cu auction_tile.cuh; do
        git show PARENT:src/repro_torch/csrc/$f > build/old/$f; done
    python3 tools/vi_segment_designs.py compare --old build/old
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def back_to_back_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls queued back to back
    between two CUDA events (the device's time when the host keeps ahead),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def build_lib(src: Path, out: Path) -> tuple[ctypes.CDLL, str]:
    from repro_torch.kernels import build
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling" in ln]


def inputs(dev):
    """The main path's inputs: the §7.1 day, an S=32 grid, Algorithm 4's
    three shapes and the segment tables at an S2A sweep's cap times."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, Segments)
    from repro_torch.core import vi as vi_lib
    from repro_torch.data import make_synthetic_env

    env = make_synthetic_env(0, 1_000_000, 100, 10, b_base=70.0, device=dev)
    n, c = env.values.shape
    base = AuctionRule(multipliers=torch.ones(c, device=dev),
                       reserve=torch.zeros((), device=dev),
                       kind="first_price")
    grid = ScenarioGrid.product(base, env.budgets, **cs.GRID_AXES)
    key = prng.PRNGKey(0)
    out = {}

    def vi_case(lanes, sample_rate, num_iters, eta_decay, budgets, mult,
                res, overlay):
        k = max(int(round(n * sample_rate)), 64)
        draws = vi_lib._draws(key, n, c, sample_size=k, num_iters=num_iters,
                              batch_size=64, coupling="shared", device=dev)
        chain = vi_lib._chain(env.values, budgets, draws, sample_size=k,
                              batch_size=64, eta=0.5, eta_decay=eta_decay)
        sampled, elig = chain.sampled, None
        if overlay:
            gen = torch.Generator(device=dev).manual_seed(7)
            noise = torch.exp(0.2 * torch.randn(
                (lanes,) + tuple(sampled.shape), generator=gen, device=dev))
            sampled = (sampled[None] * noise).contiguous()
            elig = torch.rand(sampled.shape, generator=gen,
                              device=dev) < 0.9
        btilde = chain.btilde.reshape(lanes, c).contiguous()
        args = (sampled, draws.u, chain.step, chain.denom, btilde,
                mult.reshape(lanes, c).contiguous(),
                res.reshape(lanes).contiguous(),
                torch.ones((lanes, c), device=dev))
        return args, dict(sample_size=k, second_price=False, elig=elig), \
            draws.u.shape[0]

    out["vi simulate S=1"] = vi_case(
        1, cs.VI_SIMULATE["sample_rate"], cs.VI_SIMULATE["num_iters"],
        cs.VI_SIMULATE["eta_decay"], env.budgets, torch.ones(c, device=dev),
        torch.zeros(1, device=dev), False)
    out["vi warm start S=32"] = vi_case(
        32, cs.VI_WARM["sample_rate"], cs.VI_WARM["num_iters"],
        cs.VI_WARM["eta_decay"], grid.budgets, grid.rules.multipliers,
        grid.rules.reserve, False)
    out["vi overlay S=8"] = vi_case(
        8, cs.VI_WARM["sample_rate"], cs.VI_WARM["num_iters"],
        cs.VI_WARM["eta_decay"], grid.budgets[:8], grid.rules.multipliers[:8],
        grid.rules.reserve[:8], True)

    engine = CounterfactualEngine(env.values, env.budgets, base_rule=base,
                                  device=dev)
    caps = engine.sweep(grid, method="sort2aggregate").results.cap_times
    segs = Segments.from_cap_times(caps, n)
    lanes = (grid.rules.multipliers, grid.rules.reserve, segs.boundaries,
             segs.masks)
    one = tuple(x[:1].contiguous() for x in lanes)
    epc = cs.CHUNK_EVENTS[0]
    out["segment_resolve S=32"] = ((env.values,) + lanes, dict(offset=0), n)
    out["segment_resolve one lane"] = ((env.values,) + one, dict(offset=0),
                                       n)
    out["segment_resolve offset S=32"] = (
        (env.values[3 * epc:4 * epc],) + lanes, dict(offset=3 * epc), epc)
    out["segment_resolve shard S=32"] = (
        (env.values[n // 4:n // 2],) + lanes, dict(offset=n // 4), n // 4)
    return out


def run_case(name, case, vi_mod, sg_mod):
    args, kw, _ = case
    if name.startswith("vi"):
        return vi_mod.vi_cuda(*args, **kw)[0]
    return sg_mod.segment_resolve_cuda(*args, second_price=kw.get(
        "second_price", False), offset=kw["offset"])


def compare(args) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import segment_resolve as sg_mod
    from repro_torch.kernels.auction_resolve import vi as vi_mod

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    old_dir = Path(args.old)
    libs = {"new": {}, "old": {}}
    for name, mod in (("vi", vi_mod), ("segment_resolve", sg_mod)):
        path, log, _ = build.build(name)
        libs["new"][name] = mod._lib()
        print(f"new {name}: " + "; ".join(ptxas_lines(log)), flush=True)
        old, log = build_lib(old_dir / f"{name}.cu",
                             build.BUILD_DIR / "old" / f"{name}.so")
        for fn, argtypes in mod._SIGNATURES.items():
            getattr(old, fn).argtypes = argtypes
            getattr(old, fn).restype = ctypes.c_int
        libs["old"][name] = old
        print(f"old {name}: " + "; ".join(ptxas_lines(log)), flush=True)
    cases = inputs(dev)
    torch.cuda.synchronize()
    mods = {"vi": vi_mod, "segment_resolve": sg_mod}
    print(f"card: {card}", flush=True)
    for name, case in cases.items():
        kernel = "vi" if name.startswith("vi") else "segment_resolve"
        mod = mods[kernel]
        kept = mod._lib
        reps = 3 if "warm" in name or "overlay" in name else 10
        outs, times = {}, {"old": [], "new": []}
        burst = {"old": [], "new": []}
        try:
            for design in ("old", "new", "new", "old"):
                lib = libs[design][kernel]
                mod._lib = lambda lib=lib: lib
                outs[design] = run_case(name, case, vi_mod, sg_mod)
                times[design].append(cuda_ms(
                    lambda: run_case(name, case, vi_mod, sg_mod), reps))
                burst[design].append(back_to_back_ms(
                    lambda: run_case(name, case, vi_mod, sg_mod), reps))
        finally:
            mod._lib = kept
        a, b = outs["old"], outs["new"]
        same = all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, tuple) else (a,),
            b if isinstance(b, tuple) else (b,)))
        if not same:
            print(f"{name}: the designs give other bits", flush=True)
            return 1
        steps = case[2]
        old_ms, new_ms = (statistics.mean(times[k]) for k in ("old", "new"))
        extra = (f", a step {1e3 * new_ms / steps:.4f} us (old "
                 f"{1e3 * old_ms / steps:.4f})"
                 if kernel == "vi" else "")
        b_old, b_new = (statistics.mean(burst[k]) for k in ("old", "new"))
        print(f"{card} | {name}: old {times['old'][0]:.4f}/"
              f"{times['old'][1]:.4f} ms, new {times['new'][0]:.4f}/"
              f"{times['new'][1]:.4f} ms (old, new, new, old), "
              f"{old_ms / new_ms:.3f}x{extra}; launched back to back "
              f"old {burst['old'][0]:.4f}/{burst['old'][1]:.4f} ms, new "
              f"{burst['new'][0]:.4f}/{burst['new'][1]:.4f} ms, "
              f"{b_old / b_new:.3f}x; the same bits", flush=True)
    return 0


# the first designs' anchors: (text, stamp inserted before it, after it)
VI_STAMPS = (
    ("  for (int t = 0; t < a.total; ++t) {\n", None, 7),
    ("      cp_wait_all();\n", None, 0),
    ("      __syncthreads();       // batch t is in; step t-1's update is "
     "done\n", None, 1),
    ("      v = smem + (t & 1) * nbuf;\n", 2, None),
    ("      // merge the row's slices", 3, None),
    ("    __syncthreads();\n\n    // the update of pi", 4, None),
    ("    // the update of pi, a thread a campaign", 5, None),
    ("    st = st_next;\n", 6, None),
)
VI_PHASES = ("copy wait", "barrier 1", "prefetch issue", "scan",
             "merge + store", "barrier 2", "update", "loop rest")
SG_STAMPS = (
    ("  for (int s0 = 0; s0 < a.S; s0 += kLaneChunk) {\n", 0, None),
    ("    __syncthreads();\n    for (int i = tid; i < n_lanes * cp; "
     "i += kThreads) {\n", 1, None),
    ("      vecs[i] = masked_mult(a, s0 + l, j_lo[l], i - l * cp);\n    }\n",
     None, 6),
    ('    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'
     "    __syncthreads();\n", None, 2),
    ("    // the pieces after a boundary inside the tile", 3, None),
    ("    __syncthreads();                 // before the next lanes' "
     "vectors\n", 4, 5),
)
SG_PHASES = ("staging issue", "lane bounds", "staging wait", "first pieces",
             "cut pieces", "last barrier", "vectors")
# the present designs' anchors
NEW_VI_STAMPS = (
    ("  for (int t = 0; t < a.total; ++t) {\n", None, 7),
    ("      mbar_wait(full + slot, phase);\n", None, 0),
    ("      // merge the row's slices", 1, None),
    ("    __syncthreads();        // every row resolved; the stage is read\n",
     2, 3),
    ("    // the update of pi, a thread a campaign", 4, None),
    ("    b = next_mod(b, a.n_batches);\n", 5, None),
    ("    __syncthreads();        // pi is updated\n", None, 6),
)
NEW_VI_PHASES = ("stage wait", "scan", "merge + store", "barrier 1",
                 "issue", "update", "barrier 2", "loop rest")
NEW_SG_STAMPS = (
    ("  for (int t = t0; t < t1; ++t) {\n", 4, None),
    ("    mbar_wait(full + slot, (uint32_t)((it / stages) & 1));\n", None, 0),
    ("    // the pieces after a boundary inside the tile, in rounds", 1, None),
    ("    // every thread is past the tile", 2, None),
)
NEW_SG_PHASES = ("tile wait", "first pieces", "cut rounds", "staging",
                 "setup")
PH = ("#define PH(k) { const long long _n = clock64(); _ph[k] += _n - _last;"
      " _last = _n; }\n__device__ long long g_ph[{size}];\n")


def stamped(src: str, stamps, tid_line: str, end: str, store: str,
            size: int) -> str:
    for text, before, after in stamps:
        if src.count(text) != 1:
            raise RuntimeError(f"anchor not found once: {text!r}")
        pre = f"PH({before})\n" if before is not None else ""
        post = f"PH({after})\n" if after is not None else ""
        src = src.replace(text, pre + text + post)
    if src.count(tid_line) != 1 or src.count(end) != 1:
        raise RuntimeError("kernel start or end not found once")
    src = src.replace(tid_line, tid_line + "  long long _ph[8] = {0, 0, 0, "
                      "0, 0, 0, 0, 0};\n  long long _last = clock64();\n")
    src = src.replace(end, store + end)
    src = src.replace('#include "auction_tile.cuh"\n',
                      '#include "auction_tile.cuh"\n'
                      + PH.replace("{size}", str(size)))
    return src + ("\nextern \"C\" int read_phases(long long* out, "
                  "unsigned long long n) {\n  return (int)cudaMemcpyFromSymbol("
                  "out, g_ph, n * sizeof(long long));\n}\n")


def phases(args) -> int:
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import segment_resolve as sg_mod
    from repro_torch.kernels.auction_resolve import vi as vi_mod

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    clock = smi("clocks.max.sm")
    old_dir = Path(args.old)
    out_dir = build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.design == "new":
        return phases_new(args, out_dir)
    for f in old_dir.glob("*.cuh"):
        (out_dir / f.name).write_text(f.read_text())
    vi_src = stamped(
        (old_dir / "vi.cu").read_text(), VI_STAMPS,
        "  const int tid = threadIdx.x;\n",
        "  if (kStaged) {\n    __syncthreads();\n    for (int c = tid; c < C; "
        "c += kThreads) pi_out[c] = pi[c];\n  }\n}\n",
        "  if (blockIdx.x < 32) for (int k = 0; k < 8; ++k) g_ph[((size_t)"
        "blockIdx.x * kThreads + tid) * 8 + k] = _ph[k];\n", 32 * 512 * 8)
    # the kernel's last brace follows the stamp block of the lane loop
    sg_src = stamped(
        (old_dir / "segment_resolve.cu").read_text(), SG_STAMPS,
        "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
        "template <bool kSecond>\nint launch_as(",
        "", 8192 * 8)
    sg_src = sg_src.replace(
        "PH(5)\n  }\n}\n",
        "PH(5)\n  }\n  if (tid == 0 && blockIdx.x < 8192) for (int k = 0; k < 8;"
        " ++k) g_ph[(size_t)blockIdx.x * 8 + k] = _ph[k];\n}\n", 1)
    (out_dir / "vi.cu").write_text(vi_src)
    (out_dir / "segment_resolve.cu").write_text(sg_src)
    built = {}
    for name, mod in (("vi", vi_mod), ("segment_resolve", sg_mod)):
        lib, log = build_lib(out_dir / f"{name}.cu", out_dir / f"{name}.so")
        for fn, argtypes in mod._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.read_phases.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
        built[name] = lib
        print(f"stamped {name}: " + "; ".join(ptxas_lines(log)), flush=True)
        old, log = build_lib(old_dir / f"{name}.cu",
                             out_dir / f"{name}_plain.so")
        print(f"unstamped {name}: " + "; ".join(ptxas_lines(log)),
              flush=True)
        if args.sass:
            sass = Path(args.sass)
            sass.mkdir(parents=True, exist_ok=True)
            for so in (out_dir / f"{name}_plain.so", out_dir / f"{name}.so"):
                text = subprocess.run(
                    [str(Path(build.find_nvcc()).parent / "cuobjdump"),
                     "-sass", str(so)], capture_output=True,
                    text=True).stdout
                (sass / f"{so.stem}.sass").write_text(text)
    cases = inputs(dev)
    torch.cuda.synchronize()
    print(f"card: {card}; max SM clock {clock}", flush=True)
    for name, case in cases.items():
        kernel = "vi" if name.startswith("vi") else "segment_resolve"
        mod = vi_mod if kernel == "vi" else sg_mod
        kept = mod._lib
        lib = built[kernel]
        mod._lib = lambda lib=lib: lib
        try:
            ms = cuda_ms(lambda: run_case(name, case, vi_mod, sg_mod),
                         1 if "warm" in name or "overlay" in name else 5)
        finally:
            mod._lib = kept
        if kernel == "vi":
            lanes = case[0][4].shape[0]
            buf = np.zeros(32 * 512 * 8, dtype=np.int64)
            lib.read_phases(buf.ctypes.data, buf.size)
            ph = buf.reshape(32, 512, 8)[:lanes] / case[2]
            rows = {"thread 0 (row 0, campaign 0)": ph[:, 0],
                    "thread 99 (campaign 99)": ph[:, 99],
                    "thread 511 (no campaign)": ph[:, 511],
                    "mean of all threads": ph.reshape(-1, 8)}
            print(f"{name}: {ms:.4f} ms stamped, {case[2]} steps, "
                  f"{1e6 * ms / case[2]:.1f} ns a step; cycles a step:",
                  flush=True)
            for label, x in rows.items():
                x = x.reshape(-1, 8).mean(0)
                print(f"  {label}: total {x.sum():.0f}; " + ", ".join(
                    f"{p} {v:.0f}" for p, v in zip(VI_PHASES, x)),
                    flush=True)
        else:
            tiles = -(-case[2] // sg_mod.ROWS_PER_CTA)
            buf = np.zeros(8192 * 8, dtype=np.int64)
            lib.read_phases(buf.ctypes.data, buf.size)
            ph = buf.reshape(8192, 8)[:tiles]
            x = ph.mean(0)
            cut = (ph[:, 4] > 50).mean()
            print(f"{name}: {ms:.4f} ms stamped, {tiles} tiles; cycles a "
                  f"tile (thread 0): total {x.sum():.0f}; " + ", ".join(
                      f"{p} {v:.0f}" for p, v in zip(SG_PHASES, x))
                  + f"; tiles with a cut piece {cut:.4f}", flush=True)
    return 0


def phases_new(args, out_dir: Path) -> int:
    """``phases`` on the package's sources, with the present designs'
    anchors."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import segment_resolve as sg_mod
    from repro_torch.kernels.auction_resolve import vi as vi_mod

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    for f in build.CSRC.glob("*.cuh"):
        (out_dir / f.name).write_text(f.read_text())
    tid_line = ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & "
                "31;\n")
    vi_src = stamped(
        (build.CSRC / "vi.cu").read_text(), NEW_VI_STAMPS, tid_line,
        "  if (kStaged)\n    for (int c = tid; c < C; c += kThreads) "
        "pi_out[c] = pi[c];\n}\n",
        "  if (blockIdx.x < 32) for (int k = 0; k < 8; ++k) g_ph[((size_t)"
        "blockIdx.x * kThreads + tid) * 8 + k] = _ph[k];\n", 32 * 288 * 8)
    end = "rows_of(t + stages), stride);\n  }\n}\n"
    sg_src = stamped(
        (build.CSRC / "segment_resolve.cu").read_text(), NEW_SG_STAMPS,
        tid_line, "template <bool kSecond, bool kTma, int kParts>\n"
        "int launch_as(", "", 2048 * 8)
    if sg_src.count(end) != 1:
        raise RuntimeError("segment_resolve's tile loop end not found once")
    sg_src = sg_src.replace(
        end, "rows_of(t + stages), stride);\nPH(3)\n  }\n  if (tid == 0 && "
        "blockIdx.x < 2048) for (int k = 0; k < 8; ++k) g_ph[(size_t)"
        "blockIdx.x * 8 + k] = _ph[k];\n}\n")
    (out_dir / "vi.cu").write_text(vi_src)
    (out_dir / "segment_resolve.cu").write_text(sg_src)
    built = {}
    for name, mod in (("vi", vi_mod), ("segment_resolve", sg_mod)):
        lib, log = build_lib(out_dir / f"{name}.cu", out_dir / f"{name}.so")
        for fn, argtypes in mod._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.read_phases.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
        built[name] = lib
        print(f"stamped {name}: " + "; ".join(ptxas_lines(log)), flush=True)
        if args.sass:
            sass = Path(args.sass)
            sass.mkdir(parents=True, exist_ok=True)
            plain, _, _ = build.build(name)
            text = subprocess.run(
                [str(Path(build.find_nvcc()).parent / "cuobjdump"), "-sass",
                 str(plain)], capture_output=True, text=True).stdout
            (sass / f"{name}_new.sass").write_text(text)
    cases = inputs(dev)
    torch.cuda.synchronize()
    print(f"card: {card}", flush=True)
    for name, case in cases.items():
        kernel = "vi" if name.startswith("vi") else "segment_resolve"
        mod = vi_mod if kernel == "vi" else sg_mod
        kept = mod._lib
        lib = built[kernel]
        mod._lib = lambda lib=lib: lib
        try:
            ms = cuda_ms(lambda: run_case(name, case, vi_mod, sg_mod),
                         1 if "warm" in name or "overlay" in name else 5)
        finally:
            mod._lib = kept
        if kernel == "vi":
            lanes = case[0][4].shape[0]
            buf = np.zeros(32 * 288 * 8, dtype=np.int64)
            lib.read_phases(buf.ctypes.data, buf.size)
            ph = buf.reshape(32, 288, 8)[:lanes] / case[2]
            print(f"{name}: {ms:.4f} ms stamped, {case[2]} steps; cycles a "
                  f"step:", flush=True)
            for label, x in {"thread 0 (campaign 0)": ph[:, 0],
                             "thread 99 (campaign 99)": ph[:, 99],
                             "thread 255 (no campaign)": ph[:, 255],
                             "thread 256 (stages the ring)": ph[:, 256],
                             "mean of the workers": ph[:, :256].reshape(
                                 -1, 8)}.items():
                x = x.reshape(-1, 8).mean(0)
                print(f"  {label}: total {x.sum():.0f}; " + ", ".join(
                    f"{p} {v:.0f}" for p, v in zip(NEW_VI_PHASES, x)),
                    flush=True)
        else:
            buf = np.zeros(2048 * 8, dtype=np.int64)
            lib.read_phases(buf.ctypes.data, buf.size)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            tiles = -(-case[2] // sg_mod.ROWS_PER_CTA)
            lanes = case[0][1].shape[0]
            ctas = tiles if lanes <= 8 else min(tiles, sms)
            x = buf.reshape(2048, 8)[:min(ctas, 2048)].mean(0) * ctas / tiles
            print(f"{name}: {ms:.4f} ms stamped, {tiles} tiles on {ctas} "
                  f"CTAs; cycles a tile (thread 0): " + ", ".join(
                      f"{p} {v:.0f}" for p, v in zip(NEW_SG_PHASES, x)),
                  flush=True)
    return 0


# the package's vi.cu with parts of a step cut out, to time the rest (the
# bits are not checked: a cut kernel computes something else)
VI_CUTS = {
    "no scan": ("      if (row_ok && (long long)b * B + r < a.sample_size)\n"
                "        win = quad",
                "      if (false)\n        win = quad"),
    "no update": ("    for (int c = worker ? tid : C; c < C; c += kWorkers) {",
                  "    for (int c = C; c < C; c += kWorkers) {"),
    "one quad a thread": ("C / 4, best, second)",
                          "min(C / 4, tpr), best, second)"),
    # the ring filled once: no copy lands in shared memory after the first
    # steps (the scan reads stale stages)
    "no copies after the first stages": (
        "      mbar_wait(full + slot, phase);",
        "      if (t < stages) mbar_wait(full + slot, phase);"),
    "no division": ("__fdiv_rn(acc, dn)", "acc"),
}
VI_CUTS_EXTRA = {"no copies after the first stages": (
    "      if (tid == kIssuer && t > 0 && t - 1 + stages < a.total) {",
    "      if (false) {")}


def cuts(args) -> int:
    """``vi`` at its three shapes with parts of a step cut out, against
    the whole kernel."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import vi as vi_mod

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    out_dir = build.BUILD_DIR / "cuts"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in build.CSRC.glob("*.cuh"):
        (out_dir / f.name).write_text(f.read_text())
    src = (build.CSRC / "vi.cu").read_text()
    variants = {"whole": src}
    for name, (a, b) in VI_CUTS.items():
        text = src
        for x, y in ((a, b),) + ((VI_CUTS_EXTRA[name],)
                                 if name in VI_CUTS_EXTRA else ()):
            if text.count(x) != 1:
                raise RuntimeError(f"cut {name!r}: anchor not found once")
            text = text.replace(x, y)
        variants[name] = text
    every = src
    for name in ("no scan", "no update"):
        every = every.replace(*VI_CUTS[name])
    variants["no scan or update"] = every
    libs = {}
    for i, (name, text) in enumerate(variants.items()):
        (out_dir / f"vi_{i}.cu").write_text(text)
        lib, _ = build_lib(out_dir / f"vi_{i}.cu", out_dir / f"vi_{i}.so")
        for fn, argtypes in vi_mod._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    cases = {k: v for k, v in inputs(dev).items() if k.startswith("vi")}
    kept = vi_mod._lib
    try:
        for case_name, case in cases.items():
            reps = 3 if "warm" in case_name or "overlay" in case_name else 10
            for name, lib in libs.items():
                vi_mod._lib = lambda lib=lib: lib
                ms = cuda_ms(lambda: run_case(case_name, case, vi_mod, None),
                             reps)
                print(f"{card} | {case_name}, {name}: {ms:.4f} ms, "
                      f"{1e6 * ms / case[2]:.1f} ns a step", flush=True)
    finally:
        vi_mod._lib = kept
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("compare", "phases", "cuts"))
    parser.add_argument("--old", default="build/old")
    parser.add_argument("--sass", default=None)
    parser.add_argument("--design", choices=("old", "new"), default="old",
                        help="phases: stamp the first designs (--old) or "
                             "the package's")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("vi_segment_designs: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    rc = {"compare": compare, "phases": phases, "cuts": cuts}[args.mode](args)
    print(f"{args.mode}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
