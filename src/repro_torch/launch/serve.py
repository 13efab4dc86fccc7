"""Serve a batch from the command line: prefill + budget-capped batched
greedy decode (port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --reduced --device cpu --requests 16 --max-new 48

``--arch`` serves every text-only name of ``repro_torch.configs.ARCHS``:
the dense stablelm-1.6b, gemma3-4b, gemma3-12b and internlm2-20b, the MoE
granite-moe-3b-a800m and mixtral-8x7b, the hybrid jamba-v0.1-52b and the
recurrent xlstm-125m. The CLI builds a batch of prompt tokens alone, so it
refuses (``ValueError``) the two models with a stub frontend, whisper-small
(its encoder needs frame embeddings: ``repro``'s CLI fails in ``encode``)
and internvl2-76b (its prefill needs patch embeddings: ``repro``'s CLI
serves it text alone and decodes ``num_patches`` positions past its
prefill). Serve those through ``ServeEngine.generate`` with a batch that
holds ``frames`` or ``patch_embeds``.

It takes the reference's flags plus ``--device`` (default: the CUDA card).
Weights are random from seed 0, the budgets from numpy seed 0 and the
prompts from numpy seed 1, as the reference fixes them. It plans the
compactions and serves segment 0, greedily or, with ``--temperature``,
sampled from ``prng.PRNGKey(0)`` as the reference samples.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import pick_device
from repro_torch.models import build_model
from repro_torch.serve.engine import (ServeEngine, estimate_exit_steps,
                                      plan_compactions)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = pick_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.is_encdec or cfg.num_patches:
        raise ValueError(
            f"{args.arch}: the serve CLI makes prompt tokens only, no "
            f"{'frames' if cfg.is_encdec else 'patch embeddings'} for its "
            f"stub frontend; call ServeEngine.generate with a batch that "
            f"holds them")
    model = build_model(cfg, device=dev)
    eng = ServeEngine(model, max_len=args.prompt_len + args.max_new,
                      temperature=args.temperature)

    rng = np.random.default_rng(0)
    budgets = rng.integers(args.max_new // 4, args.max_new,
                           size=args.requests)
    exits = estimate_exit_steps(budgets)
    plan = plan_compactions(exits, max_segments=args.segments,
                            total_steps=int(budgets.max()))
    print(f"[serve] {args.requests} requests, budgets {budgets.tolist()}")
    print(f"[serve] compaction plan: {plan.segments}")

    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len))
    tokens = torch.from_numpy(prompts).to(dev)
    t0 = time.perf_counter()
    toks = eng.generate(tokens, num_steps=min(args.max_new,
                                              plan.segments[0][1]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = toks.numel()
    print(f"[serve] segment 0 on {dev}: {tuple(toks.shape)} tokens in "
          f"{dt:.3f}s ({n_tok / dt:.0f} tok/s)")
    return toks


if __name__ == "__main__":
    main()
