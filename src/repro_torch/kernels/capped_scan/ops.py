"""Public wrapper of the capped-scan kernel (port of
``repro.kernels.capped_scan.ops:15``).

It dispatches on the device: a CUDA tensor goes to the hand-written kernel
(:mod:`.capped_scan`), which launches or raises; a CPU tensor goes to the
plain version (:mod:`.ref`). There is no padding: the kernel takes any N,
and C up to its register limit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.capped_scan.capped_scan import capped_scan_cuda
from repro_torch.kernels.capped_scan.ref import capped_scan_ref


def capped_scan(values: torch.Tensor, budgets: torch.Tensor,
                multipliers: torch.Tensor | None = None, reserve=0.0, *,
                second_price: bool = False):
    """Exact budget-capped sequential replay of ``values`` (N, C).

    One lane: ``budgets`` and ``multipliers`` (C,), ``reserve`` a scalar;
    returns ``(winners (N,) int32 [-1 = no sale], prices (N,) float32,
    final spend (C,) float32, cap times (C,) int32)``, a cap time 1-based
    and N+1 for never. S lanes: budgets and multipliers (S, C), reserves a
    scalar or (S,); every output gains a leading (S,) axis. ``multipliers``
    defaults to ones. First price is ``repro``'s ``capped_scan``; second
    price pays max(second-highest eligible bid, reserve).
    """
    one_lane = budgets.ndim == 1
    dev = values.device
    b = budgets.reshape(-1, values.shape[1]).to(device=dev,
                                                  dtype=torch.float32)
    s = b.shape[0]
    if multipliers is None:
        multipliers = torch.ones_like(b)
    mult = multipliers.reshape(s, -1).to(device=dev, dtype=torch.float32)
    res = torch.as_tensor(reserve, dtype=torch.float32, device=dev)
    res = res.reshape(-1).expand(s).contiguous()
    if dev.type == "cpu":
        out = capped_scan_ref(values, b, mult, res, second_price=second_price)
    else:
        out = capped_scan_cuda(values.contiguous(), b.contiguous(),
                               mult.contiguous(), res,
                               second_price=second_price)
    return tuple(x[0] for x in out) if one_lane else out
