#!/usr/bin/env python3
"""Two designs of the first-crossing kernels (``src/repro_torch/csrc/
first_crossing.cu``) on the card, at the main path's shapes.

The shapes (§7.1's day, N=1e6, C=100, an S=32 grid; every lane resolved
under its segment table at an S2A sweep's cap times, as the replays see
it):

* S=32 at ``block=4096``: the final S2A pass (spends and caps) and a
  refine pass (caps only);
* one lane, both modes (``simulate``'s passes);
* the chunked S2A replay's call: a 125,000-row chunk at offset 375,000
  with a carry, ``block=15,625``, caps only (``segments.crossing_carry``);
* the sharded crossing: shard 1 of 4 (250,000 rows at offset 250,000)
  with the carry of shard 0, ``block = local_n``, spends and caps
  (``segments.shard_crossing``);
* the whole day at ``block=15,625`` (``sweep(method="sort2aggregate",
  crossing_block=15_625)``), both modes.

``split`` times one design's calls (the package's build, or ``--old DIR``)
and traces them with ``torch.profiler``: each call's device kernels by
name, their launches and device time a call.

``compare`` builds another copy of the source (``--old DIR``: a directory
holding ``first_crossing.cu``, such as a parent commit's unpacked by ``git
show`` into a directory that ``.gitignore`` lists) and times it against
the package's build in turns (old, new, new, old; CUDA-event medians),
through the package's wrapper on the same inputs. A caps-only case runs
the old design as the full call it replaces. The cap times, the carried
running spend and, where both compute them, the flat sums must be the
same bits.

Run from the repository root on a CUDA machine, for example:

    mkdir -p build/old
    git show PARENT:src/repro_torch/csrc/first_crossing.cu \\
        > build/old/first_crossing.cu
    python3 tools/first_crossing_designs.py compare --old build/old
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNK, CHUNK_AT, CHUNK_BLOCK = 125_000, 375_000, 15_625
SHARDS = 4


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
    """``{name: (kwargs of first_crossing_cuda, spends asked)}`` at the
    main path's shapes (module docstring)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, Segments)
    from repro_torch.core import segments as seg_lib
    from repro_torch.data import make_synthetic_env
    from repro_torch.kernels.auction_resolve import ops

    env = make_synthetic_env(0, 1_000_000, 100, 10, b_base=70.0, device=dev)
    n, c = env.values.shape
    base = AuctionRule(multipliers=torch.ones(c, device=dev),
                       reserve=torch.zeros((), device=dev),
                       kind="first_price")
    grid = ScenarioGrid.product(base, env.budgets, **cs.GRID_AXES)
    engine = CounterfactualEngine(env.values, env.budgets, base_rule=base,
                                  device=dev)
    caps = engine.sweep(grid, method="sort2aggregate").results.cap_times
    segs = Segments.from_cap_times(caps, n)
    w, p = ops.segment_resolve(env.values, grid.rules.multipliers,
                               grid.rules.reserve, segs.boundaries,
                               segs.masks)
    b = grid.budgets.to(torch.float32).contiguous()
    s = b.shape[0]
    zero = (torch.zeros((s, c), device=dev),
            torch.full((s, c), n + 1, dtype=torch.int32, device=dev))
    # the chunked replay's carry at the chunk's offset
    s0, cap = zero
    for off in range(0, CHUNK_AT, CHUNK):
        s0, cap = seg_lib.crossing_carry(
            w[:, off:off + CHUNK].contiguous(),
            p[:, off:off + CHUNK].contiguous(), b, c, CHUNK_BLOCK, s0=s0,
            cap=cap, offset=off, n_global=n)
    local_n = n // SHARDS
    sh_s0, sh_cap = seg_lib.crossing_carry(
        w[:, :local_n].contiguous(), p[:, :local_n].contiguous(), b, c,
        local_n, s0=zero[0], cap=zero[1], offset=0, n_global=n)
    torch.cuda.synchronize()
    w1, p1, b1 = w[:1].contiguous(), p[:1].contiguous(), b[:1].contiguous()
    chunk = dict(winners=w[:, CHUNK_AT:CHUNK_AT + CHUNK].contiguous(),
                 prices=p[:, CHUNK_AT:CHUNK_AT + CHUNK].contiguous(),
                 budgets=b, num_campaigns=c, block=CHUNK_BLOCK,
                 carry=(s0, cap, CHUNK_AT, n))
    shard = dict(winners=w[:, local_n:2 * local_n].contiguous(),
                 prices=p[:, local_n:2 * local_n].contiguous(), budgets=b,
                 num_campaigns=c, block=local_n,
                 carry=(sh_s0, sh_cap, local_n, n))

    def whole(ww, pp, bb, block=4096):
        return dict(winners=ww, prices=pp, budgets=bb, num_campaigns=c,
                    block=block)
    return {
        "S=32, block 4,096, spends and caps": (whole(w, p, b), True),
        "S=32, block 4,096, caps only": (whole(w, p, b), False),
        "one lane, block 4,096, spends and caps": (whole(w1, p1, b1), True),
        "one lane, block 4,096, caps only": (whole(w1, p1, b1), False),
        "S=32, 125,000-row chunk, carry, block 15,625, caps only":
            (chunk, False),
        "S=32, shard 1 of 4, carry, block = local_n, spends and caps":
            (shard, True),
        "S=32, block 15,625, spends and caps":
            (whole(w, p, b, CHUNK_BLOCK), True),
        "S=32, block 15,625, caps only": (whole(w, p, b, CHUNK_BLOCK),
                                          False),
    }


def call(kw, spends: bool):
    from repro_torch.kernels.auction_resolve.first_crossing import \
        first_crossing_cuda
    return first_crossing_cuda(spend=spends, **kw)


def load_old(old_dir: Path):
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import first_crossing as fc_mod
    old, log = build_lib(old_dir / "first_crossing.cu",
                         build.BUILD_DIR / "old" / "first_crossing.so")
    for fn, argtypes in fc_mod._SIGNATURES.items():
        getattr(old, fn).argtypes = argtypes
        getattr(old, fn).restype = ctypes.c_int
    old.fc_scratch_bytes.restype = ctypes.c_longlong
    old.fc_device_kernels.restype = ctypes.c_longlong
    print("old first_crossing: " + "; ".join(ptxas_lines(log)), flush=True)
    return old


def split_of(fn, reps: int) -> dict:
    """``{kernel name: (launches, device ms)}`` a call of ``fn``, traced
    over ``reps`` calls (``chip_smoke.trace``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    fn()
    counts: dict = {}
    by_kernel = cs.trace("[fc]", f"{reps} calls", lambda: [
        fn() for _ in range(reps)], counts)
    return {name: (counts[name] / reps, us / 1e3 / reps)
            for name, us in by_kernel.items()}


def short(kernel: str) -> str:
    """``block_kernel<true, false>`` of a demangled kernel name."""
    found = re.search(r"(\w+_kernel(<[^>]*>)?)", kernel)
    return found.group(1) if found else kernel[:40]


def print_split(card: str, design: str, name: str, split: dict) -> None:
    total = sum(ms for _, ms in split.values())
    parts = "; ".join(f"{short(k)} x{n:g} {ms:.4f} ms"
                      for k, (n, ms) in split.items())
    print(f"{card} | {design} | {name}: device {total:.4f} ms a call: "
          f"{parts}", flush=True)


def split(args) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import first_crossing as fc_mod
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    design = "new"
    if args.old:
        old = load_old(Path(args.old))
        fc_mod._lib = lambda: old
        design = "old"
    else:
        _, log, _ = build.build("first_crossing")
        print("first_crossing: " + "; ".join(ptxas_lines(log)), flush=True)
    cases = inputs(dev)
    print(f"card: {card}", flush=True)
    for name, (kw, spends) in cases.items():
        spends = spends or design == "old"
        ms = cuda_ms(lambda: call(kw, spends), 10)
        print(f"{card} | {design} | {name}: {ms:.4f} ms (CUDA-event median "
              f"of 10)", flush=True)
        print_split(card, design, name,
                    split_of(lambda: call(kw, spends), 5))
    return 0


def compare(args) -> int:
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.auction_resolve import first_crossing as fc_mod
    dev = torch.device("cuda")
    card = smi("name,power.limit")
    _, log, _ = build.build("first_crossing")
    print("new first_crossing: " + "; ".join(ptxas_lines(log)), flush=True)
    libs = {"new": fc_mod._lib(), "old": load_old(Path(args.old))}
    cases = inputs(dev)
    print(f"card: {card}", flush=True)
    kept = fc_mod._lib
    try:
        for name, (kw, spends) in cases.items():
            outs, times = {}, {"old": [], "new": []}
            asked = {"old": True, "new": spends}
            for design in ("old", "new", "new", "old"):
                lib = libs[design]
                fc_mod._lib = lambda lib=lib: lib
                outs[design] = call(kw, asked[design])
                times[design].append(cuda_ms(
                    lambda: call(kw, asked[design]), 10))
            fc_mod._lib = lambda: libs["new"]
            split_new = split_of(lambda: call(kw, spends), 5)
            a, b = outs["old"], outs["new"]
            pairs = [(a[0], b[0])] + ([(a[1], b[1])] if spends else []) \
                + ([(a[2], b[2])] if len(a) == 3 else [])
            if not all(torch.equal(x, y) for x, y in pairs):
                print(f"{name}: the designs give other bits", flush=True)
                return 1
            old_ms, new_ms = (statistics.mean(times[k])
                              for k in ("old", "new"))
            floor = ""
            if spends:
                floor_ms, run = cs.chain_floor_ms(kw["winners"],
                                                  kw["num_campaigns"])
                floor = (f"; the flat sums' chain floor {floor_ms:.4f} ms "
                         f"({run} sales of one (lane, campaign))")
            print(f"{card} | {name}: old {times['old'][0]:.4f}/"
                  f"{times['old'][1]:.4f} ms, new {times['new'][0]:.4f}/"
                  f"{times['new'][1]:.4f} ms (old, new, new, old), "
                  f"{old_ms / new_ms:.3f}x; the same bits{floor}",
                  flush=True)
            print_split(card, "new", name, split_new)
    finally:
        fc_mod._lib = kept
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("split", "compare"))
    parser.add_argument("--old", default=None,
                        help="a directory holding another first_crossing.cu"
                             " (compare: required; split: time it instead)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("first_crossing_designs: no CUDA device", file=sys.stderr)
        return 2
    if args.mode == "compare" and not args.old:
        parser.error("compare needs --old DIR")
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    rc = {"split": split, "compare": compare}[args.mode](args)
    print(f"{args.mode}: {time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
