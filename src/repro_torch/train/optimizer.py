"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.train.optimizer``).

The state mirrors the parameters: float32 moments ``mu`` and ``nu`` keyed
like the parameters, and an int32 ``step``. :meth:`AdamW.update` repeats
the float32 arithmetic of ``repro``'s update as XLA's CPU backend compiles
it, found from its optimised HLO and checked bit for bit against it:

* the norm is the square root (correctly rounded) of the leaves' sums
  added in the leaves' order from 0, each leaf's sum of squares in XLA's
  windows of 32 (:func:`repro_torch.floats.xla_sum` of the flattened
  squares). That is XLA's order for a vector; for a leaf of several dims
  XLA windows every dim and its last small reduction takes an order that
  depends on the shape, so there the norm can differ in its last bit;
* ``scale = min(1 / max(norm, 1e-9), 1)`` (``clip_norm / max(...)``);
* ``mu = fma(mu, b1, (g * scale) * (1 - b1))`` and ``nu = fma(nu, b2,
  ((g * scale) * (1 - b2)) * (g * scale))``: LLVM contracts each sum of
  products into one fused multiply-add (:func:`repro_torch.floats.fma`);
* ``b1 ** step`` is the C library's ``powf`` (:func:`repro_torch.floats.
  powf`);
* the algebraic simplifier rewrites ``(mu / c1) / (sqrt(nu / c2) + eps)``
  as ``mu / (c1 * (sqrt(nu / c2) + eps))``, and the decay and the step
  are two more fused multiply-adds: ``p_new = fma(-lr, fma(p, wd, base),
  p)``.

So an update from the same moments, gradients and parameters is
``repro``'s bit for bit wherever the norms agree (always for vector
leaves; for any leaves when the gradients are not clipped, as the scale
is then exactly 1), on the CPU and on the card (every operation is IEEE
float32 or exact). The update works in place, as the reference's
jitted step donates its state: it overwrites the parameters and the
moments it is given. Each leaf's update and sum of squares go through
:func:`repro_torch.kernels.meta.repeatable` (a plain call, except under
the dry run's cost count).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import floats
from repro_torch.kernels import meta as kernel_meta

Params = Dict[str, torch.Tensor]
# leaves are updated in pieces of at most this many elements, which bounds
# the float64 temporaries of floats.fma
_PIECE = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Params              # first moment, float32, keyed like the params
    nu: Params              # second moment


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> AdamWState:
        """Zero float32 moments like ``params`` and step 0, on their
        device."""
        first = next(iter(params.values()))
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for k, p in params.items()}
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=zeros, nu={k: z.clone() for k, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState,
               params: Params) -> Tuple[Params, AdamWState, dict]:
        """One step: clip ``grads`` by their global norm, update the
        moments and the parameters in place (``params`` and the state's
        ``mu`` and ``nu`` are overwritten) and return ``(params, new
        state, {"grad_norm", "lr"})``."""
        gnorm = global_norm(grads)
        scale = torch.minimum(
            _f32(self.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-9),
            _f32(1.0, gnorm))
        step = state.step + 1
        lr = self.learning_rate(step).to(torch.float32)
        t = float(step)
        c1 = 1 - floats.powf(torch.tensor(self.b1), t).to(gnorm.device)
        c2 = 1 - floats.powf(torch.tensor(self.b2), t).to(gnorm.device)
        b1, b2 = _f32(self.b1, gnorm), _f32(self.b2, gnorm)
        ob1, ob2 = _f32(1 - self.b1, gnorm), _f32(1 - self.b2, gnorm)
        eps, wd = _f32(self.eps, gnorm), _f32(self.weight_decay, gnorm)
        consts = (scale, lr, c1, c2, b1, b2, ob1, ob2, eps, wd)
        for name, p in params.items():
            kernel_meta.repeatable(_update_leaf, p, grads[name],
                                   state.mu[name], state.nu[name], consts)
        new_state = AdamWState(step=step, mu=state.mu, nu=state.nu)
        return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _update_leaf(p, g, mu, nu, consts) -> None:
    """The update of one leaf ``p`` from its gradient ``g``, in place
    (``p``, ``mu`` and ``nu``), a piece of ``_PIECE`` elements at a
    time."""
    scale, lr, c1, c2, b1, b2, ob1, ob2, eps, wd = consts
    g_all = g.reshape(-1)
    m_all = mu.view(-1)
    v_all = nu.view(-1)
    p_all = p.detach().view(-1)
    for lo in range(0, p_all.numel(), _PIECE):
        piece = slice(lo, lo + _PIECE)
        g = g_all[piece].float() * scale
        m = floats.fma(m_all[piece], b1, g * ob1)
        v = floats.fma(v_all[piece], b2, (g * ob2) * g)
        # float64's root rounded to float32 is the correctly rounded one
        # (torch's float32 sqrt on the CPU is not always)
        root = torch.sqrt((v / c2).double()).float()
        base = m / (c1 * (root + eps))
        pf = p_all[piece].float()
        new = floats.fma(-lr, floats.fma(pf, wd, base), pf)
        m_all[piece] = m
        v_all[piece] = v
        p_all[piece] = new.to(p.dtype)


def _sum_squares(leaf: torch.Tensor) -> torch.Tensor:
    flat = leaf.float().reshape(-1)
    return floats.xla_sum(flat * flat)


def global_norm(tree: Params) -> torch.Tensor:
    """``sqrt`` of the sum of every leaf's squares, float32: each leaf's
    sum in XLA's windows of 32 (:func:`repro_torch.floats.xla_sum` of the
    flattened squares), the leaves added in order from 0, the root
    correctly rounded."""
    total = None
    for leaf in tree.values():
        s = kernel_meta.repeatable(_sum_squares, leaf)
        total = s if total is None else total + s
    return torch.sqrt(total.double()).float()


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable:
    """The learning rate at a step (an int tensor): linear from 0 to
    ``peak`` over ``warmup_steps``, then a cosine from ``peak`` to ``floor
    * peak`` at ``total_steps``, in float32, in the form XLA's simplifier
    gives ``repro``'s: ``s * (peak / w)``, ``clip((s - w) * (1 / (total -
    w)), 0, 1)``, ``fma(1 + cos(pi * frac), (1 - floor) / 2, floor) *
    peak``, the quotients of constants rounded to float32. ``torch.cos``
    is not XLA's, so a step past the warmup can differ in its last bit."""
    w = max(warmup_steps, 1)
    span = max(total_steps - warmup_steps, 1)

    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = s * _f32(np.float32(peak) / np.float32(w), s)
        frac = torch.clamp((s - warmup_steps)
                           * _f32(np.float32(1) / np.float32(span), s),
                           0.0, 1.0)
        cos = torch.cos(frac * _f32(math.pi, s))
        decay = floats.fma(cos + 1, _f32((1 - floor) * 0.5, s),
                           _f32(floor, s)) * _f32(peak, s)
        return torch.where(s < warmup_steps, warm, decay)
    return schedule


def constant_lr(value: float) -> Callable:
    """The learning rate ``value`` at every step, float32."""
    return lambda step: _f32(value, step)
