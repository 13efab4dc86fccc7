"""Parameter initialisation (port of ``repro.models.spec:159-181``, only
what the serving model needs).

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

Sharding rules, ``partition_spec`` and the mesh context are not ported:
without a mesh they do nothing in the reference.
"""
from __future__ import annotations

import math

import torch
from torch import nn


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
