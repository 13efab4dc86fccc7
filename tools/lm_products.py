#!/usr/bin/env python3
"""How accurate are the card's bfloat16 products, and how close do the
card and the CPU come on the LMs of ``chip_smoke.py`` phase 16 with each
way of computing them?

The port computes its models' products as plain bfloat16 ``torch``
products: cuBLAS's tensor-core GEMMs on the card. This script measures
what other arithmetic would change, on a CUDA machine, from the
repository root:

    python3 tools/lm_products.py [accuracy] [floor] [seeds] [stablelm]
                                 [SEED ...]

* ``accuracy``: random bfloat16 operands at the LMs' shapes; the share of
  outputs off the exactly rounded product (float64 on the host, rounded to
  bfloat16) and the largest error over the largest output, for the CPU's
  bfloat16 GEMM, the card's (cuBLAS, bfloat16 operands), TF32 on float32
  copies, and a float32 SGEMM.
* ``floor``: for each seed (default 0 1 2; weights from the seed, tokens
  from seed + 1, as ``chip_smoke.py`` draws them), jamba-v0.1-52b cut to 2
  layers and xlstm-125m cut to its first 6 (5 mLSTM, 1 sLSTM) at full
  width, with each product variant: ``bf16`` (the port's), ``moe-f32``
  (every product inside ``moe_apply`` a float32 GEMM rounded to
  bfloat16) and ``all-f32`` (every bfloat16 product on the card so). It
  prints the card against the CPU (``chip_smoke.card_against_cpu``'s 2 x
  256 tokens and 8 teacher-forced decode steps; max |diff| / max |CPU| of
  the logits, the prefill and the worst decode step), each layer alone on
  the same inputs (:func:`block_errors`), and whether a second card run
  gives the same logits.
* ``seeds``: ``chip_smoke.card_against_cpu`` for each of phase 16's
  models at its check's cut, for each seed, with nothing required: the
  bfloat16 logits and the float32 twins' (the readings ``LM_TOL`` and
  ``F32_TOL`` are set against).
* ``stablelm``: stablelm-1.6b whole, the prefill of 8 x 2,048 tokens
  (median of 3) with ``bf16`` (the port's) and ``all-f32`` products, in
  turns: bf16, all-f32, all-f32, bf16.

It prints the card's name and power limit first. With no mode it runs
all four.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((512, 4096, 14336), (2, 14336, 4096), (512, 8192, 4096),
          (2, 4096, 16384), (2, 8192, 4096))
VARIANTS = ("bf16", "moe-f32", "all-f32")


@contextlib.contextmanager
def products(variant: str):
    """The models' products computed as ``variant`` says while the context
    is open (``bf16``: as the port computes them)."""
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.models import moe

    class Float32Products(TorchFunctionMode):
        funcs = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                 torch.einsum, torch.bmm}

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            if (func in self.funcs and ts and ts[0].is_cuda
                    and ts[0].dtype == torch.bfloat16):
                wide = [a.float() if isinstance(a, torch.Tensor) else a
                        for a in args]
                return func(*wide, **kwargs).to(torch.bfloat16)
            return func(*args, **kwargs)

    saved = moe.moe_apply

    def moe_f32(*args, **kwargs):
        with Float32Products():
            return saved(*args, **kwargs)

    if variant == "moe-f32":
        moe.moe_apply = moe_f32
    try:
        with (Float32Products() if variant == "all-f32"
              else contextlib.nullcontext()):
            yield
    finally:
        moe.moe_apply = saved


def accuracy():
    import torch
    gen = torch.Generator().manual_seed(0)
    for m, k, n in SHAPES:
        x = torch.randn(m, k, generator=gen).bfloat16()
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).bfloat16()
        exact = (x.double() @ w.double()).bfloat16().float()
        xc, wc = x.cuda(), w.cuda()
        got = {"cpu bf16": x @ w, "card bf16": (xc @ wc).cpu()}
        torch.backends.cuda.matmul.allow_tf32 = True
        got["card tf32"] = (xc.float() @ wc.float()).bfloat16().cpu()
        torch.backends.cuda.matmul.allow_tf32 = False
        got["card float32"] = (xc.float() @ wc.float()).bfloat16().cpu()
        parts = []
        for name, r in got.items():
            r = r.float()
            off = float((r != exact).float().mean())
            err = float((r - exact).abs().max() / exact.abs().max())
            parts.append(f"{name}: {off:.5f} off, max {err:.5f}")
        print(f"(M, K, N) = {(m, k, n)}: " + "; ".join(parts), flush=True)


def run(model, seq):
    """``card_against_cpu``'s prefill and teacher-forced decode steps: the
    logits of each, on the host in float32."""
    import chip_smoke as cs
    prompt, steps = cs.LM_CPU_PROMPT, cs.LM_CPU_STEPS
    d = model.device
    logits, caches = model.prefill(seq[:, :prompt].to(d), prompt + steps)
    out = [logits.float().cpu()]
    for i in range(steps):
        pos = prompt + i
        logits, caches = model.decode_step(
            caches, seq[:, pos:pos + 1].to(d), pos)
        out.append(logits.float().cpu())
    return out


def block_errors(card, cpu, cfg, seed) -> dict:
    """Each layer alone on the same inputs: the card's input to every
    block (and, in decode, the card's cache) is copied to the CPU, and the
    block's increment to the residual stream (its output less its input,
    in float32) is compared between the two, max |diff| over max |CPU|, for
    the prefill of ``chip_smoke.card_against_cpu``'s prompts and each of its
    teacher-forced decode steps. Rounding cannot build up from layer to
    layer. MoE routing is followed as there. Returns the worst of each
    layer."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.models.layers import embed
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.lm import apply_block
    max_len = cs.LM_CPU_PROMPT + cs.LM_CPU_STEPS
    seq = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (cs.LM_CPU_REQUESTS, max_len)))
    worst = [0.0] * cfg.n_layers
    caches = [None] * cfg.n_layers

    def on_cpu(cache):
        return None if cache is None else type(cache)(*(t.cpu()
                                                         for t in cache))

    for step in range(cs.LM_CPU_STEPS + 1):
        if step == 0:
            mode, pos, toks = "prefill", None, seq[:, :cs.LM_CPU_PROMPT]
            positions = torch.arange(cs.LM_CPU_PROMPT)[None, :]
        else:
            pos = cs.LM_CPU_PROMPT + step - 1
            mode, toks, positions = "decode", seq[:, pos:pos + 1], None
        x = embed(card.embed.table, toks.to(card.device))
        for layer in range(cfg.n_layers):
            routes = []
            with moe_lib.record_routing(routes):
                y, new_cache = apply_block(
                    card.blocks[layer], x, cfg, mode, caches[layer], pos,
                    None if positions is None else positions.to(x.device),
                    max_len)
            with moe_lib.follow_routing(routes, cs.ROUTE_DRIFT):
                y_cpu, _ = apply_block(cpu.blocks[layer], x.cpu(), cfg, mode,
                                       on_cpu(caches[layer]), pos, positions,
                                       max_len)
            got = y.float().cpu() - x.float().cpu()
            want = y_cpu.float() - x.float().cpu()
            rel = float((got - want).abs().max() / want.abs().max())
            worst[layer] = max(worst[layer], rel)
            x, caches[layer] = y, new_cache
    return dict(layers=worst)


def floor(seeds):
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.models import moe as moe_lib

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for arch, layers in (("jamba-v0.1-52b", 2), ("xlstm-125m", 6)):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        has_moe = any(ls.moe for ls in cfg.layers)
        for seed in seeds:
            t0 = time.perf_counter()
            card = build_model(cfg, device="cuda", seed=seed)
            cpu = Model(cfg, device="cpu")
            cpu.load_state_dict(card.state_dict())
            seq = torch.from_numpy(np.random.default_rng(seed + 1).integers(
                0, cfg.vocab_size,
                (cs.LM_CPU_REQUESTS, cs.LM_CPU_PROMPT + cs.LM_CPU_STEPS)))
            for variant in VARIANTS if has_moe else ("bf16", "all-f32"):
                with products(variant):
                    routes = []
                    with moe_lib.record_routing(routes):
                        on_card = run(card, seq)
                    with moe_lib.follow_routing(routes, cs.ROUTE_DRIFT) \
                            as ties:
                        on_cpu = run(cpu, seq)
                    blocks = block_errors(card, cpu, cfg, seed)
                    again = (run(card, seq)
                             if variant == "bf16" else None)
                errs = [rel(a, b) for a, b in zip(on_card, on_cpu)]
                same = ("" if again is None else
                        f"; a second card run gives the same logits: "
                        f"{all(map(torch.equal, on_card, again))}")
                print(f"{arch} cut to {layers} layers, seed {seed}, {variant}"
                      f" products: card vs CPU prefill {errs[0]:.5f}, decode "
                      f"max {max(errs[1:]):.5f} (steps "
                      f"{[round(e, 5) for e in errs[1:]]}), {len(ties)} near "
                      f"ties; each layer alone "
                      f"{[round(e, 5) for e in blocks['layers']]}{same}",
                      flush=True)
            del card, cpu
            torch.cuda.empty_cache()
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)


def seeds_mode(seeds):
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import Model, build_model
    from repro_torch.models import moe as moe_lib
    cs.F32_TOL = float("inf")
    for arch, _, layers, _ in cs.MIXER_MODELS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        for seed in seeds:
            card = build_model(cfg, device="cuda", seed=seed)
            cpu = Model(cfg, device="cpu")
            cpu.load_state_dict(card.state_dict())
            cs.card_against_cpu(f"{arch} seed {seed}", card, cpu, cfg, seed,
                                moe_lib, bf16_bounded=False)
            del card, cpu
            torch.cuda.empty_cache()


def stablelm():
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine
    cfg = get_config(cs.LM_ARCH)
    model = build_model(cfg, device="cuda", seed=0)
    engine = ServeEngine(model, max_len=cs.LM_PROMPT + cs.LM_STEPS)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (cs.LM_REQUESTS, cs.LM_PROMPT))).cuda()
    for variant in ("bf16", "all-f32", "all-f32", "bf16"):
        with products(variant):
            engine.prefill(tokens)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.prefill(tokens)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        print(f"{cs.LM_ARCH} prefill of {cs.LM_REQUESTS} x {cs.LM_PROMPT} "
              f"tokens, {variant} products: {statistics.median(times):.4f} s "
              f"(median of 3)", flush=True)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_products: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi("name,power.limit"), flush=True)
    modes = [a for a in argv if not a.isdigit()] or [
        "accuracy", "floor", "seeds", "stablelm"]
    seeds = [int(a) for a in argv if a.isdigit()] or [0, 1, 2]
    if "accuracy" in modes:
        accuracy()
    if "floor" in modes:
        floor(seeds)
    if "seeds" in modes or "stablelm" in modes:
        from repro_torch.kernels import build
        build.build_all(["flash_attention"])
    if "seeds" in modes:
        seeds_mode(seeds)
    if "stablelm" in modes:
        stablelm()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
