"""Synthetic token pipeline for LM training (port of
``repro.data.tokens``).

A deterministic stream: each step's batch comes from a key folded from
the seed and the step, so a restart regenerates exactly the batches it
would have seen, bit for bit ``repro``'s (every draw is
:mod:`repro_torch.prng`'s, ``jax.random``'s bits). The "corpus" is a
Zipf-distributed token model with local n-gram structure: with
probability 0.35 a token repeats the one before it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator

import torch

from repro_torch import floats, prng
from repro_torch.device import DeviceLike, pick_device


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    patch_embeds: int = 0          # vlm stub frontend
    patch_dim: int = 0
    frames: int = 0                # audio stub frontend
    frame_dim: int = 0
    device: DeviceLike = None      # the card unless "cpu"

    @functools.cached_property
    def _probs(self) -> torch.Tensor:
        """Zipf probabilities ``ranks ** -a / sum``: the power is the C
        library's ``powf`` (XLA CPU's), the sum in XLA's windows of 32."""
        ranks = torch.arange(1, self.vocab_size + 1, dtype=torch.float32)
        p = floats.powf(ranks, -self.zipf_a)
        return (p / floats.xla_sum(p)).to(pick_device(self.device))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The batch of ``step``: ``tokens`` and ``labels`` (B, S - P)
        int32 (the next tokens), and the stub frontends' bfloat16
        ``patch_embeds`` (B, P, d) or ``frames`` (B, F, d), on the
        pipeline's device."""
        dev = pick_device(self.device)
        key = prng.fold_in(prng.PRNGKey(self.seed, device=dev), step)
        k_tok, k_shift, k_patch, k_frame = prng.split(key, 4)
        b, s = self.global_batch, self.seq_len
        s_text = s - self.patch_embeds
        toks = prng.choice(k_tok, self.vocab_size, (b, s_text + 1),
                           replace=True, p=self._probs).to(torch.int32)
        rep = prng.bernoulli(k_shift, 0.35, (b, s_text + 1))
        toks = torch.where(rep, torch.roll(toks, 1, dims=1), toks)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.patch_embeds:
            out["patch_embeds"] = prng.normal(
                k_patch, (b, self.patch_embeds, self.patch_dim),
                torch.bfloat16)
        if self.frames:
            out["frames"] = prng.normal(
                k_frame, (b, self.frames, self.frame_dim), torch.bfloat16)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def pipeline_for(cfg, seq_len: int, global_batch: int, seed: int = 0, *,
                 device: DeviceLike = None) -> TokenPipeline:
    """The pipeline of ``cfg``'s vocabulary and stub frontends."""
    return TokenPipeline(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        patch_embeds=cfg.num_patches, patch_dim=cfg.d_model,
        frames=cfg.encoder_frames, frame_dim=cfg.d_model, device=device)
