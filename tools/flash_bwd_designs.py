#!/usr/bin/env python3
"""The flash-attention backward (``src/repro_torch/csrc/flash_attention_bwd.cu``)
on the card at the training shapes of ``chip_smoke.py``'s phase 18 (a).

It builds the package's kernels, prints ``-Xptxas -v`` (registers, shared
memory and spills of every instantiation) and, at each shape in bfloat16,
holds the kernel against the plain backward (``ref.attention_bwd_ref``)
and the CPU mirror of its roundings (``ref.attention_bwd_bf16_ref``, run
on the card), requires the same bits from two launches and times it
(CUDA-event medians) beside its bound (five products at the bf16
tensor-core peak) and the design's floor (seven).

``--old DIR`` also builds another copy of the two attention sources (a
directory holding ``flash_attention_bwd.cu`` and ``flash_attention.cu``
with the headers they include, such as a parent commit's ``csrc/``
unpacked by ``git show`` into a directory that ``.gitignore`` lists) and:

* times the two backward designs in turns (old, new, new, old) on the same
  inputs, bfloat16 at every shape;
* requires the float32 route's bits of both designs to be equal, at the
  shapes ``chip_smoke.py`` runs in float32;
* requires the two forwards' outputs and logsumexps to be equal, in both
  types;
* times stablelm-1.6b's full-width train step (8 x 2,048 tokens in 2
  microbatches, 48 backward launches, as ``chip_smoke.py``'s phase 18
  (b)) with each backward design in turns (old, new, new, old; 3 steps a
  turn after a warm-up, host clock to a synchronise), so that a kernel's
  gain can be read end to end within one call.

Run from the repository root on a CUDA machine, for example:

    mkdir -p build/old
    for f in flash_attention_bwd.cu flash_attention.cu; do
        git show PARENT:src/repro_torch/csrc/$f > build/old/$f; done
    python3 tools/flash_bwd_designs.py --old build/old
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
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12
# (b, s, h, kv, dh, causal, window, label): chip_smoke.py's BWD_SHAPES
SHAPES = ((4, 2048, 32, 32, 64, True, None, "stablelm-1.6b"),
          (4, 2048, 24, 8, 64, True, None, "granite-moe-3b"),
          (1, 4096, 8, 4, 256, True, 1024, "gemma3-4b local"),
          (8, 1500, 12, 12, 64, False, None, "whisper-small encoder"),
          (1, 2048, 64, 8, 128, True, None, "internvl2-76b"))
F32_LABELS = ("stablelm-1.6b", "whisper-small encoder")


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


def pairs(b, s, h, causal, window) -> float:
    """(query, key) pairs the mask keeps, over every (b, h)."""
    import torch
    rows = torch.arange(s, dtype=torch.float64)
    seen = rows + 1 if causal else torch.full_like(rows, s)
    if window is not None:
        before = torch.clamp(rows + 1, max=window)
        seen = before if causal else before + (s - 1 - rows)
    return b * h * float(seen.sum())


def inputs(dev, b, s, h, kv, dh, causal, window, dtype):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(s + h + dh)
    q, do = (torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     with_lse=True)
    return q, k, v, o, do, lse


def rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def with_lib(mod, lib, fn):
    kept = mod._lib
    mod._lib = lambda: lib
    try:
        return fn()
    finally:
        mod._lib = kept


def run(args) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import ref

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    for name in ("flash_attention", "flash_attention_bwd"):
        _, log, seconds = build.build(name)
        print(f"{name}: nvcc {seconds:.1f} s", flush=True)
        for line in ptxas_lines(log):
            print(f"  {line}", flush=True)
    old = fwd_old = None
    if args.old:
        old_dir = Path(args.old)
        old, log = build_lib(old_dir / "flash_attention_bwd.cu",
                             build.BUILD_DIR / "old" / "fa_bwd.so")
        fwd_old, _ = build_lib(old_dir / "flash_attention.cu",
                               build.BUILD_DIR / "old" / "fa_fwd.so")
        from repro_torch.kernels.flash_attention import flash_attention as fa
        for lib, sigs in ((old, fab._SIGNATURES), (fwd_old, fa._SIGNATURES)):
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        print("old flash_attention_bwd: " + "; ".join(
            ln for ln in ptxas_lines(log) if "Used" in ln or "spill" in ln),
            flush=True)
    failed = False
    for b, s, h, kv, dh, causal, window, label in SHAPES:
        for dname in ("bfloat16", "float32"):
            if dname == "float32" and (old is None or label not in F32_LABELS):
                continue
            dtype = getattr(torch, dname)
            q, k, v, o, do, lse = inputs(dev, b, s, h, kv, dh, causal,
                                         window, dtype)
            kw = dict(causal=causal, window=window)

            def new():
                return fab.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)

            def prev():
                return with_lib(fab, old, new)

            tag = f"{card} | {label} {dname}"
            got, again = new(), new()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                print(f"{tag}: two launches gave other bits", flush=True)
                failed = True
            if dname == "float32":
                before = prev()
                same = all(torch.equal(x, y) for x, y in zip(got, before))
                print(f"{tag}: the float32 route "
                      f"{'gives the old design' if same else 'DIFFERS from the old design'}"
                      f"'s bits", flush=True)
                failed |= not same
                continue
            plain = ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
            mirror = ref.attention_bwd_bf16_ref(q, k, v, o, do, lse, **kw)
            e_plain = [rel(x, y) for x, y in zip(got, plain)]
            e_mirror = [rel(x, y) for x, y in zip(got, mirror)]
            e_m_plain = [rel(x, y) for x, y in zip(mirror, plain)]
            failed |= max(e_plain) > 2e-2
            del plain, mirror, again
            n_pairs = pairs(b, s, h, causal, window)
            bound = max(5 * 2 * n_pairs * dh / BF16_OPS_PER_S,
                        ((4 * q.numel() + 4 * k.numel()) * q.element_size()
                         + lse.numel() * 4) / HBM_BYTES_PER_S) * 1e3
            floor = 7 * 2 * n_pairs * dh / BF16_OPS_PER_S * 1e3
            times = {"old": [], "new": []}
            order = ("old", "new", "new", "old") if old else ("new",)
            for design in order:
                times[design].append(cuda_ms(new if design == "new" else prev,
                                             args.reps))
            ms = statistics.mean(times["new"])
            line = (f"{tag} (B={b}, S={s}, H={h}, KV={kv}, dh={dh}): new "
                    f"{'/'.join(f'{t:.4f}' for t in times['new'])} ms, "
                    f"{5 * 2 * n_pairs * dh / ms / 1e9:.1f} TFLOP/s on five "
                    f"products; bound {bound:.4f} ms, 7-product floor "
                    f"{floor:.4f} ms")
            if old:
                old_ms = statistics.mean(times["old"])
                line += (f"; old {'/'.join(f'{t:.4f}' for t in times['old'])}"
                         f" ms (old, new, new, old), {old_ms / ms:.2f}x")
            line += (f"; dq, dk, dv against plain "
                     f"{', '.join(f'{e:.3g}' for e in e_plain)}, against "
                     f"the mirror {', '.join(f'{e:.3g}' for e in e_mirror)}"
                     f" (mirror against plain "
                     f"{', '.join(f'{e:.3g}' for e in e_m_plain)})")
            print(line, flush=True)
            del q, k, v, o, do, lse, got
            torch.cuda.empty_cache()
    if fwd_old is not None:
        from repro_torch.kernels.flash_attention import flash_attention as fa
        for b, s, h, kv, dh, causal, window, label in SHAPES:
            for dtype in (torch.bfloat16, torch.float32):
                gen = torch.Generator(device=dev).manual_seed(s + dh)
                q = torch.randn((b, s, h, dh), generator=gen,
                                device=dev).to(dtype)
                k, v = (torch.randn((b, s, kv, dh), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))

                def fwd():
                    return fa.flash_attention_cuda(
                        q, k, v, causal=causal, window=window, with_lse=True)

                new_out = fwd()
                old_out = with_lib(fa, fwd_old, fwd)
                same = all(torch.equal(x, y) for x, y in zip(new_out,
                                                             old_out))
                print(f"{card} | forward {label} {dtype}: "
                      f"{'the same bits' if same else 'OTHER BITS'} as the "
                      f"old build", flush=True)
                failed |= not same
        torch.cuda.empty_cache()
        train_steps(dev, fab, old, card)
    return 1 if failed else 0


def train_steps(dev, fab, old, card: str, reps: int = 3) -> None:
    """stablelm-1.6b's train step at full width with the package's backward
    and with ``old``'s, in turns; prints each turn's median step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline_for
    from repro_torch.models import new_model
    from repro_torch.train import AdamW, constant_lr, init_state, \
        make_train_step

    cfg = get_config("stablelm-1.6b")
    model = new_model(cfg, device=dev, param_dtype=torch.float32)
    adamw = AdamW(learning_rate=constant_lr(3e-4))
    box = {"state": init_state(model, adamw, 0)}
    step = make_train_step(model, adamw, microbatches=2)
    pipe = pipeline_for(cfg, seq_len=2048, global_batch=8, seed=0,
                        device=dev)
    box["state"], _ = step(box["state"], pipe.batch(0))     # warm-up
    turns = {"old": [], "new": []}
    batch = 1
    for design in ("old", "new", "new", "old"):
        times = []
        for _ in range(reps):
            def one(b=pipe.batch(batch)):
                box["state"], _ = step(box["state"], b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if design == "old":
                with_lib(fab, old, one)
            else:
                one()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            batch += 1
        turns[design].append(statistics.median(times))
    tokens = 8 * 2048
    old_s, new_s = (statistics.mean(turns[k]) for k in ("old", "new"))
    print(f"{card} | stablelm-1.6b train step, 8 x 2048 tokens: old "
          f"{'/'.join(f'{t:.4f}' for t in turns['old'])} s, new "
          f"{'/'.join(f'{t:.4f}' for t in turns['new'])} s (old, new, new, "
          f"old; medians of {reps} steps), {tokens / old_s:.6g} against "
          f"{tokens / new_s:.6g} tokens/s, {old_s - new_s:.4f} s saved a "
          f"step", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--old", help="a directory holding another "
                        "design's flash_attention_bwd.cu and "
                        "flash_attention.cu")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_designs: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
