"""Parameter initialisation and logical axes (port of
``repro.models.spec``).

A weight is created empty with its shape and serving dtype
(:func:`new_param`) and filled by :func:`init_params` from a seeded
``torch.Generator`` on the weight's device. The initialisers are the
reference's: ``normal`` draws a standard normal times ``scale /
sqrt(fan_in)``, where ``fan_in`` is the per-layer weight's first dimension
(the reference's pre-stack ``fan_in``: ``e`` for an (e, d, f) expert
weight, ``h`` for sLSTM's (h, dh, dh) ``r_g``) or the only one of a vector
and ``scale`` is 1 unless the module's ``SCALE`` mapping names the
weight (the reference's ``ParamSpec.scale``); ``embed`` has std 1;
``ones``; ``zeros``. Each is drawn in float32 and then cast, as the
reference's float32 masters are cast to the compute dtype. A module names
the initialiser of each of its own parameters in its ``INIT`` mapping;
``normal`` is the default. The bits are not ``jax.random``'s: tests carry
the reference's parameters across (:mod:`repro_torch.interop`).

Logical axes (``repro.models.spec:39-122``). A module names the logical
axes of each of its parameters in its ``LOGICAL`` mapping, beside its
``INIT`` and ``SCALE``: the reference's ``ParamSpec.logical``, without the
leading ``layers`` entry of a stacked leaf (the port keeps one module a
layer). :func:`partition_spec` maps logical axes to mesh axes by the
rules (:data:`DEFAULT_RULES`, overridden per architecture by the dry
run): a dim is sharded only where its size divides by the mesh extent,
and a mesh axis shards at most one dim. It returns a plain tuple, one
entry a dim: ``None``, an axis name, or a tuple of names. The mesh is
anything with ``axis_names`` and ``sizes``
(:class:`repro_torch.launch.mesh.LogicalMesh`, or a device
:class:`~repro_torch.launch.mesh.Mesh`). :func:`param_logical`,
:func:`tree_pspecs` and :func:`count_params` read a model's named
parameters.

Logical axis vocabulary (rules map these to mesh axes or None):

  batch      global batch                      -> ("pod", "data")
  seq        sequence                          -> None (SP = hillclimb lever)
  act_seq    residual stream's sequence        -> None ("model" for SP)
  embed      d_model / input features          -> "data"   (FSDP)
  heads      query heads                       -> "model"  (TP)
  kv_heads   kv heads (GQA, < TP size)         -> None (replicated; cheap)
  head_dim   per-head dim                      -> None
  ff         MLP hidden                        -> "model"  (TP)
  vocab      vocab rows                        -> "model"  (TP; sharded CE)
  expert     MoE experts                       -> None (TP on ff) or "model" (EP)
  layers     stacked layer groups              -> None
  kv_seq     KV-cache sequence (decode)        -> "model"  (flash-decoding style)
  inner      mamba/xlstm inner dim             -> "model"
  conv / state / frames / misc small dims      -> None
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

Logical = Tuple[Optional[str], ...]
Spec = Tuple[Any, ...]

DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,
    "embed": "data",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "expert": None,
    "layers": None,
    "kv_seq": "model",
    "inner": "model",
    "state": None,
    "conv": None,
    "frames": None,
}


def resolve_rules(overrides: Optional[Mapping[str, Any]] = None
                  ) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.axis_names, mesh.sizes))


def _mesh_axes_of(rules: Mapping[str, Any], logical: Optional[str],
                  dim: int, sizes: Mapping[str, int]) -> Any:
    if logical is None:
        return None
    axes = rules.get(logical, None)
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    # axes the mesh lacks drop out ("pod" on one pod)
    axes = tuple(a for a in axes if a in sizes)
    if not axes:
        return None
    # a dim the mesh extent does not divide stays replicated
    if dim % math.prod(sizes[a] for a in axes) != 0:
        return None
    return axes if len(axes) > 1 else axes[0]


def partition_spec(logical: Logical, shape: Tuple[int, ...], mesh,
                   rules: Mapping[str, Any]) -> Spec:
    """The mesh axes of each dim of a ``shape`` with ``logical`` axes."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} for shape {tuple(shape)}")
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        ax = _mesh_axes_of(rules, name, dim, sizes)
        if ax is not None:
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            if any(a in used for a in flat):
                ax = None
            else:
                used.update(flat)
        out.append(ax)
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[Tuple[str, ...], ...]:
    """Each dim's mesh axes as a tuple (empty where replicated)."""
    return tuple(() if ax is None else (ax,) if isinstance(ax, str)
                 else tuple(ax) for ax in spec)


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard."""
    sizes = mesh_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in axes)
                 for n, axes in zip(shape, spec_axes(spec)))


def param_logical(model: nn.Module) -> Dict[str, Logical]:
    """Every parameter's logical axes by name, from the ``LOGICAL``
    mapping of the module that owns it; a parameter without one raises
    ``KeyError``."""
    out = {}
    for prefix, sub in model.named_modules():
        table = getattr(sub, "LOGICAL", {})
        for name, p in sub.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            if name not in table:
                raise KeyError(f"{type(sub).__name__} names no logical axes "
                               f"for {full}")
            if len(table[name]) != p.ndim:
                raise ValueError(f"{full}: logical axes {table[name]} for "
                                 f"shape {tuple(p.shape)}")
            out[full] = tuple(table[name])
    return out


def tree_pspecs(model: nn.Module, mesh, rules: Mapping[str, Any]
                ) -> Dict[str, Spec]:
    """Every parameter's partition spec by name."""
    shapes = dict(model.named_parameters())
    return {name: partition_spec(logical, tuple(shapes[name].shape), mesh,
                                 rules)
            for name, logical in param_logical(model).items()}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def new_param(shape, dtype: torch.dtype, device: torch.device
              ) -> nn.Parameter:
    """An uninitialised weight; serving takes no gradients."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def init_tensor_(t: torch.Tensor, init: str,
                 generator: torch.Generator, scale: float = 1.0) -> None:
    """Fill ``t`` in place with the reference's initialiser ``init``:
    ``normal`` (std ``scale / sqrt(fan_in)``), ``embed``, ``ones`` or
    ``zeros``."""
    if init == "zeros":
        t.zero_()
        return
    if init == "ones":
        t.fill_(1.0)
        return
    fan_in = t.shape[0] if t.ndim >= 2 else t.shape[-1]
    std = 1.0 if init == "embed" else scale / math.sqrt(max(fan_in, 1))
    draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                       device=t.device)
    t.copy_(draw * std)


def init_params(module: nn.Module, seed: int) -> None:
    """Fill every parameter of ``module`` from one ``torch.Generator``
    seeded with ``seed`` on the parameters' device, in registration
    order."""
    first = next(module.parameters())
    gen = torch.Generator(device=first.device).manual_seed(seed)
    for sub in module.modules():
        kinds = getattr(sub, "INIT", {})
        scales = getattr(sub, "SCALE", {})
        for name, p in sub.named_parameters(recurse=False):
            init_tensor_(p.data, kinds.get(name, "normal"), gen,
                         scales.get(name, 1.0))
