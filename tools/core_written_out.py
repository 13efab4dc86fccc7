#!/usr/bin/env python3
"""Is sharing the resolve core slower than writing it out?

The partials kernel (``src/repro_torch/csrc/round_fused.cu``) and the
scenario-batched resolve (``sweep_resolve.cu``) share their resolve core,
``lane_resolve.cuh``: ``__forceinline__`` device templates that each source
includes. This script builds ``round_fused.cu`` twice with the port's nvcc
flags, as committed and with the header's text pasted in place of its
``#include`` (the core written out in the source), and times one full-day
partials pass of each (N=1,000,000, C=100, S=32, both pricing rules; CUDA
events, median of 20, in turns: shared, written out, written out, shared).
The two must give the same bits. Run from the repository root on a CUDA
machine:

    python3 tools/core_written_out.py
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("core_written_out: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.segments import REDUCE_BLOCKS as G
    from repro_torch.data import make_synthetic_env
    from repro_torch.kernels import build
    from repro_torch.kernels.binding import I, P

    out_dir = build.BUILD_DIR / "written_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "round_fused.cu").read_text()
    header = (build.CSRC / "lane_resolve.cuh").read_text()
    include = '#include "lane_resolve.cuh"'
    if src.count(include) != 1:
        raise RuntimeError("round_fused.cu should include the core once")
    (out_dir / "round_fused.cu").write_text(src.replace(include, header))
    (out_dir / "auction_tile.cuh").write_text(
        (build.CSRC / "auction_tile.cuh").read_text())
    libs = {}
    for name, path in (("shared", build.CSRC / "round_fused.cu"),
                       ("written out", out_dir / "round_fused.cu")):
        so = out_dir / f"{name.replace(' ', '_')}.so"
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                        str(path)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.rf_sweep_partials.argtypes = [P] * 8 + [I] * 9 + [P]
        libs[name] = lib

    dev = torch.device("cuda")
    env = make_synthetic_env(0, 1_000_000, 100, 10, b_base=70.0, device=dev)
    n, c = env.values.shape
    s, block = 32, -(-n // G)
    gen = torch.Generator(device=dev).manual_seed(1)
    mult = 0.8 + 0.5 * torch.rand((s, c), generator=gen, device=dev)
    act = torch.ones((s, c), dtype=torch.bool, device=dev)
    res = torch.linspace(0.0, 0.05, s, device=dev)
    lo = torch.zeros(s, dtype=torch.int32, device=dev)
    hi = torch.full((s,), n, dtype=torch.int32, device=dev)
    alive = torch.ones(s, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def launch(lib, parts, second):
        err = lib.rf_sweep_partials(
            env.values.data_ptr(), mult.data_ptr(), act.data_ptr(),
            res.data_ptr(), lo.data_ptr(), hi.data_ptr(), alive.data_ptr(),
            parts.data_ptr(), s, n, c, 0, n, block, G, int(second), 1,
            stream)
        if err != 0:
            raise RuntimeError(f"rf_sweep_partials: cudaError_t {err}")

    for second in (False, True):
        parts = {k: torch.empty((s, G, c), device=dev) for k in libs}
        times = {k: [] for k in libs}
        for name in ("shared", "written out", "written out", "shared"):
            launch(libs[name], parts[name], second)
            torch.cuda.synchronize()
            for _ in range(10):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                launch(libs[name], parts[name], second)
                b.record()
                b.synchronize()
                times[name].append(a.elapsed_time(b))
        if not torch.equal(parts["shared"], parts["written out"]):
            raise RuntimeError("the two builds gave other bits")
        rule = "second price" if second else "first price"
        print(f"{card}: full-day partials pass, {rule}: shared core "
              f"{statistics.median(times['shared']):.4f} ms, written out "
              f"{statistics.median(times['written out']):.4f} ms, the same "
              f"bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
