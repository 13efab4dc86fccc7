"""Carry a scenario batch from the reference package's arrays into the port.

The reference (JAX) package's arrays reach the port as numpy arrays — what
``np.asarray`` gives for them. Those are often read-only views, so they are
copied before torch takes them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.counterfactual import ScenarioGrid
from repro_torch.core.types import AuctionRule
from repro_torch.device import DeviceLike, pick_device


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(device)


def from_reference(values, budgets, multipliers, reserves, kind: str,
                   labels: Optional[Sequence[str]] = None, *,
                   device: DeviceLike = None
                   ) -> Tuple[torch.Tensor, ScenarioGrid]:
    """Build the port's ``values`` (N, C) tensor and a :class:`ScenarioGrid`
    from numpy arrays: ``budgets`` and ``multipliers`` (S, C), ``reserves``
    (S,), one pricing ``kind``. Values are copied bit for bit."""
    dev = pick_device(device)
    budgets = _tensor(budgets, np.float32, dev)
    rules = AuctionRule(multipliers=_tensor(multipliers, np.float32, dev),
                        reserve=_tensor(reserves, np.float32, dev),
                        kind=kind)
    if labels is None:
        labels = [f"scenario{i}" for i in range(budgets.shape[0])]
    grid = ScenarioGrid(rules=rules, budgets=budgets, labels=tuple(labels))
    return _tensor(values, np.float32, dev), grid
