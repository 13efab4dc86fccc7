"""Model runtime context: sharding constraints and the scan-unroll policy
(port of ``repro.models.runtime``).

Models are mesh-agnostic; the dry run installs a context (a logical mesh
and logical-to-mesh rules) and the model code names the layouts it wants
at the reference's call sites: :func:`constrain` pins an activation's
layout at block boundaries, :func:`gather_weight` a weight's layout at its
use (the hill climb's ``_gather_weights`` lever). Without a context every
call is a no-op that returns its argument itself.

``repro`` hands these layouts to GSPMD. The port has no partitioner: under
a context, :func:`constrain` and :func:`gather_weight` record the layout
asked for (a :class:`Layout`: the logical axes, the resolved partition
spec and, for a gathered weight, the spec with the FSDP axis stripped) in
the context's ``records`` and pass it to the context's ``listener``, the
dry run's cost count (:mod:`repro_torch.launch.hlo_cost`), which accounts
the collectives of such a layout. They return their argument itself,
inside a context as outside, so serving and training keep their bits,
launches and host syncs.

``scan_unroll`` is the reference's unroll policy for ``lax.scan``. The
port's layer and chunk loops are Python loops, which the cost count sees
op by op, so nothing of the port reads it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, List, Mapping, Optional, Tuple

from repro_torch.models import spec as spec_lib

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class Layout:
    """One recorded layout: ``kind`` ``"constrain"`` or ``"gather"``."""
    kind: str
    logical: Tuple[Optional[str], ...]
    shape: Tuple[int, ...]
    spec: spec_lib.Spec
    gathered: Optional[spec_lib.Spec] = None


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: Any
    rules: Mapping[str, Any]
    unroll_scans: bool = False
    listener: Any = None
    records: List[Layout] = dataclasses.field(default_factory=list,
                                              compare=False)


def current() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Mapping[str, Any], unroll_scans: bool = False,
                 listener: Any = None):
    """Install a context for the block; the previous one comes back after
    it (contexts nest)."""
    prev = current()
    _STATE.ctx = ShardingCtx(mesh=mesh, rules=rules,
                             unroll_scans=unroll_scans, listener=listener)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def constrain(x, logical: Tuple[Optional[str], ...]):
    """Name x's layout by its logical axes under the active context."""
    ctx = current()
    if ctx is None or x is None:
        return x
    spec = spec_lib.partition_spec(logical, tuple(x.shape), ctx.mesh,
                                   ctx.rules)
    ctx.records.append(Layout("constrain", tuple(logical), tuple(x.shape),
                              spec))
    if ctx.listener is not None:
        ctx.listener.constrain(x, spec)
    return x


def scan_unroll(length: int) -> int:
    """``lax.scan``'s unroll amount: full unroll in roofline mode, 1
    otherwise."""
    ctx = current()
    if ctx is not None and ctx.unroll_scans:
        return max(length, 1)
    return 1


def fsdp_stripped(rules: Mapping[str, Any]) -> dict:
    """The rules with the ``"data"`` axis taken out of every mapping: a
    weight's compute-time layout under ``_gather_weights`` (ZeRO-3: cast
    to the compute dtype, all-gather over ``data``, compute with the
    whole weight)."""
    out = dict(rules)
    for k, v in rules.items():
        if v is None or k.startswith("_"):
            continue
        axes = tuple(a for a in ((v,) if isinstance(v, str) else v)
                     if a != "data")
        out[k] = axes[0] if len(axes) == 1 else (axes or None)
    return out


def gather_weight(w, logical: Tuple[Optional[str], ...]):
    """The hill climb's ``_gather_weights`` lever: name the compute-time
    layout of the (compute-dtype) weight ``w``, model axes only."""
    ctx = current()
    if ctx is None or not ctx.rules.get("_gather_weights"):
        return w
    shape = tuple(w.shape)
    ctx.records.append(Layout(
        "gather", tuple(logical), shape,
        spec_lib.partition_spec(logical, shape, ctx.mesh, ctx.rules),
        spec_lib.partition_spec(logical, shape, ctx.mesh,
                                fsdp_stripped(ctx.rules))))
    return w
