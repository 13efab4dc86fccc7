"""Serving engine: prefill, greedy or sampled decode, and the
budget-capped batch planner (port of ``repro.serve.engine``).

:class:`ServeEngine` runs a :class:`repro_torch.models.Model` (or the
encoder-decoder, :class:`repro_torch.models.EncDecModel`) eagerly on the
model's device (the reference jits its prefill and decode steps): prefill
through the flash-attention kernel, then one decode step per token. A
token is the ``argmax`` over the true vocabulary at ``temperature <= 0``,
else a draw of :func:`repro_torch.prng.categorical` on the bfloat16
logits divided by the temperature: ``jax.random.categorical``'s bits,
with the reference's key schedule.

The second half is the reference's beyond-paper bridge, copied as it is
(numpy): a decode batch where every request carries a token budget and
irreversibly exits at EOS or budget, planned SORT2AGGREGATE-style into
fixed-shape segments between compaction points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models.model import AnyModel

Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# plain engine

@dataclasses.dataclass
class ServeEngine:
    model: AnyModel
    max_len: int
    temperature: float = 0.0

    def prefill(self, batch: Batch):
        """The last position's logits and the decode caches of
        ``max_len`` positions. ``batch`` is the prompt tokens (B, S), or
        the reference's batch: a dict of ``tokens`` and the stub
        frontends' ``frames`` (B, F, d) or ``patch_embeds`` (B, P, d),
        which the model's prefill takes by keyword (it raises
        ``ValueError`` for a missing one)."""
        dev = self.model.device
        if isinstance(batch, torch.Tensor):
            return self.model.prefill(batch.to(dev), max_len=self.max_len)
        extra = {k: v.to(dev) for k, v in batch.items() if k != "tokens"}
        return self.model.prefill(batch["tokens"].to(dev),
                                  max_len=self.max_len, **extra)

    def _sample(self, logits: torch.Tensor,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The next token of each row (int32), on the logits' device:
        ``argmax`` at ``temperature <= 0`` (``key`` unused), else
        ``prng.categorical(key, logits / temperature)``, the division in
        the logits' dtype by the temperature rounded to it (jax's weakly
        typed scalar)."""
        logits = logits[:, -1, : self.model.cfg.vocab_size]
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if key is None:
            raise ValueError("sampling at temperature > 0 needs a key")
        t = torch.tensor(self.temperature, dtype=torch.float32).to(
            logits.dtype)
        return prng.categorical(key.to(logits.device),
                                logits / t.to(logits.device)).to(torch.int32)

    def generate(self, batch: Batch, num_steps: int,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy or temperature generation from ``batch`` (see
        :meth:`prefill`). Returns (B, num_steps) int32 tokens on the
        model's device. Makes one prefill and ``num_steps`` decode steps,
        as the reference does: the first token is drawn with ``key``
        (default ``prng.PRNGKey(0)``), each later one with the second key
        of a split of the previous key; the positions count the patches.
        No step waits for the host: the keys are split on the model's
        device, and only at ``temperature > 0`` (a greedy token uses no
        key, so skipping the splits leaves the tokens as they were)."""
        sampling = self.temperature > 0.0
        if sampling:
            key = (prng.PRNGKey(0) if key is None else key).to(
                self.model.device)
        sub = key
        logits, caches = self.prefill(batch)
        tokens = batch if isinstance(batch, torch.Tensor) else \
            batch["tokens"]
        prompt_len = tokens.shape[1] + (self.model.cfg.num_patches or 0)
        outs = []
        tok = self._sample(logits, key)
        for i in range(num_steps):
            outs.append(tok)
            logits, caches = self.model.decode_step(caches, tok[:, None],
                                                    prompt_len + i)
            if sampling:
                key, sub = prng.split(key)
            tok = self._sample(logits, sub)
        return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# budget-capped batched serving (burnout-variable scheduling)

@dataclasses.dataclass
class RequestBatch:
    prompts: torch.Tensor                # (B, S) prompt tokens
    token_budgets: np.ndarray            # (B,) max new tokens per request
    eos_id: int = -1


@dataclasses.dataclass
class ServePlan:
    """Piecewise-constant batch schedule: between compaction points the batch
    is fixed-shape (one compiled program per segment width)."""
    exit_estimates: np.ndarray           # (B,) estimated exit step
    compaction_points: List[int]         # sorted decode steps to re-pack at
    segments: List[Tuple[int, int, int]]  # (start, end, live_count)


def estimate_exit_steps(
    token_budgets: np.ndarray,
    eos_survival: float = 0.98,
    key: Optional[np.random.Generator] = None,
    n_samples: int = 64,
) -> np.ndarray:
    """Uncertainty-relaxed exit-step estimate.

    A request exits at min(budget, first EOS). With per-step survival
    probability ``eos_survival``, the EOS time is geometric; we estimate
    E[min(budget, G)] with the *shared-uniform* coupling of core.vi (one
    uniform per step across requests), which preserves the rank statistics
    that the compaction plan depends on.
    """
    rng = key or np.random.default_rng(0)
    b = token_budgets.shape[0]
    if b == 0:
        return np.zeros((0,), np.float64)
    u = rng.random((n_samples, 1, token_budgets.max()))
    # shared across requests (axis 1 broadcast): comonotone coupling
    alive = np.cumprod(u < eos_survival, axis=2)          # (S, 1, T)
    steps = alive.sum(axis=2)                              # (S, 1)
    exits = np.minimum(token_budgets[None, :], steps)      # (S, B)
    return exits.mean(axis=0)


def plan_compactions(exit_estimates: np.ndarray, max_segments: int = 4,
                     total_steps: Optional[int] = None) -> ServePlan:
    """SORT2AGGREGATE for serving: sort exit estimates, pick K compaction
    points that minimise wasted slot-steps (batch slots kept alive past their
    request's exit), aggregate into fixed-shape segments."""
    b = exit_estimates.shape[0]
    if b == 0:
        return ServePlan(exit_estimates=exit_estimates,
                         compaction_points=[], segments=[])
    total = int(total_steps or exit_estimates.max())
    order = np.sort(exit_estimates.astype(np.int64))
    # candidate compaction at each distinct exit; greedy pick the K with the
    # largest saved area (slots freed x remaining steps)
    savings = []
    for i, t in enumerate(order[:-1]):
        freed = i + 1
        savings.append((int(freed) * int(max(total - t, 0)), int(t)))
    savings.sort(reverse=True)
    points = sorted({t for _, t in savings[: max_segments - 1] if t > 0})
    segments = []
    start = 0
    for p in points + [total]:
        live = int((exit_estimates > start).sum())
        segments.append((start, int(p), live))
        start = int(p)
    return ServePlan(exit_estimates=exit_estimates,
                     compaction_points=points, segments=segments)


def wasted_slot_steps(plan: ServePlan, true_exits: np.ndarray) -> int:
    """Evaluation metric: slot-steps spent on already-exited requests.

    Vectorized over the step axis: the active count at step ``t`` is
    ``B - searchsorted(sorted_exits, t, 'right')`` (exits strictly after
    ``t``), and each segment contributes ``max(live - active, 0)`` per
    step — O(B log B + T) instead of the O(B·T) per-step recount.
    """
    if not plan.segments:
        return 0
    total = plan.segments[-1][1]
    exits = np.sort(np.asarray(true_exits))
    t = np.arange(total)
    active = exits.size - np.searchsorted(exits, t, side="right")
    live = np.zeros(total, dtype=np.int64)
    for start, end, seg_live in plan.segments:
        live[start:end] = seg_live
    return int(np.maximum(live - active, 0).sum())
