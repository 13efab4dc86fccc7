"""Training driver (port of ``repro.launch.train``).

Composes the substrate: config -> model of float32 masters -> train step
-> token pipeline -> checkpoint/restart loop with failure handling and
straggler tracking. Reduced configs run end to end on the CPU; full
widths on the CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --device cpu --steps 100 --batch 8 --seq 64 \\
      --ckpt-dir /tmp/ckpt

It takes the reference's flags plus ``--device`` (default: the CUDA
card). Every architecture trains: dense, windowed, MoE, encoder-decoder,
VLM and the recurrent mixers (mamba, mLSTM, sLSTM). Weights come from a
``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s bits);
the batches are ``repro``'s bit for bit.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.tokens import pipeline_for
from repro_torch.device import DeviceLike, pick_device
from repro_torch.fault import FailureInjector, StragglerPolicy, WorkerFailure
from repro_torch.models import new_model
from repro_torch.train import (AdamW, bind_state, init_state,
                               make_train_step, warmup_cosine)


def train_loop(cfg, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | Path, microbatches: int = 1,
               lr: float = 3e-4, ckpt_every: int = 20,
               failure_injector: FailureInjector | None = None,
               log_every: int = 10, seed: int = 0,
               max_restarts: int = 3, device: DeviceLike = None):
    """Train ``cfg`` for ``steps`` steps from ``seed`` (or from the latest
    checkpoint under ``ckpt_dir``), checkpointing every ``ckpt_every``
    steps and at the end (``AsyncCheckpointer(keep=3)``); a
    ``WorkerFailure`` restarts from the last checkpoint (or from scratch
    if none), at most ``max_restarts`` times. Returns ``(state, losses)``,
    ``losses`` one float a step run (a step run again after a restart
    appears again)."""
    dev = pick_device(device)
    model = new_model(cfg, device=dev, param_dtype=torch.float32)
    opt = AdamW(learning_rate=warmup_cosine(lr, min(20, steps // 5 or 1),
                                            steps))
    step_fn = make_train_step(model, opt, microbatches=microbatches)
    pipe = pipeline_for(cfg, seq_len=seq_len, global_batch=global_batch,
                        seed=seed, device=dev)
    stragglers = StragglerPolicy()
    ckpt = AsyncCheckpointer(ckpt_dir, keep=3)

    def restore(state):
        restored, manifest = restore_checkpoint(ckpt_dir, state, device=dev)
        return bind_state(model, restored), manifest["step"]

    state = init_state(model, opt, seed)
    start = 0
    if latest_step(ckpt_dir) is not None:
        state, start = restore(state)
        print(f"[train] resumed from step {start}")

    losses = []
    restarts = 0
    i = start
    while i < steps:
        try:
            t0 = time.monotonic()
            if failure_injector is not None:
                failure_injector.check(i)
            state, metrics = step_fn(state, pipe.batch(i))
            loss = float(metrics["loss"])
            losses.append(loss)
            stragglers.record(0, time.monotonic() - t0)
            i += 1
            if i % ckpt_every == 0 or i == steps:
                ckpt.save(i, state, extra={"loss": loss})
            if i % log_every == 0:
                print(f"[train] step {i}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e}")
        except WorkerFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            print(f"[train] {e} — restarting from last checkpoint")
            ckpt.wait()
            if latest_step(ckpt_dir) is not None:
                state, i = restore(state)
            else:
                state = init_state(model, opt, seed)
                i = 0
            failure_injector = None   # the failed worker was "replaced"
    ckpt.close()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    injector = None
    if args.inject_failure_at >= 0:
        injector = FailureInjector(schedule={args.inject_failure_at: 0})
    t0 = time.time()
    _, losses = train_loop(cfg, steps=args.steps, global_batch=args.batch,
                           seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                           microbatches=args.microbatches, lr=args.lr,
                           failure_injector=injector, device=args.device)
    print(f"[train] done in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f}")
    return losses


if __name__ == "__main__":
    main()
