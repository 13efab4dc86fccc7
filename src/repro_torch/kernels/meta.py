"""Work reports of the kernel wrappers' ``meta`` route.

On the ``meta`` device a wrapper launches nothing and computes nothing:
it returns empty outputs of its kernel's shapes and dtypes and reports the
work its call stands for (a :class:`Work`) to the listener of the active
runtime context (``repro_torch.models.runtime``; the dry run's cost count,
:class:`repro_torch.launch.hlo_cost.CostCounter`), which also gives the
outputs their layouts. With no listener a report is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Work:
    """One call: ``inputs`` (q, k, v first), ``outputs`` with their
    ``roles`` (``"q"``, ``"k"``, ``"v"``: shaped like that input;
    ``"lse"``: (B, H, S) row statistics), the products' FLOPs and the
    share of them the masks keep (``useful_flops``)."""
    name: str
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    roles: Tuple[str, ...]
    flops: float
    useful_flops: float


def _listener():
    # imported here: the models import the kernels
    from repro_torch.models import runtime
    ctx = runtime.current()
    return None if ctx is None else ctx.listener


def repeatable(fn, *args):
    """``fn(*args)``. Under a listener (the dry run's cost count) a call
    whose arguments have the shapes, dtypes and layouts of an earlier
    call's may be counted from that call's record instead of run again:
    ``fn`` must return a tensor or None and change nothing but its result
    and its arguments in place."""
    listener = _listener()
    if listener is None:
        return fn(*args)
    return listener.repeatable(fn, args)


def report(work: Work) -> None:
    listener = _listener()
    if listener is not None:
        listener.kernel(work)
