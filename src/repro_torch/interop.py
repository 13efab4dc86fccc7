"""Carry a scenario batch, a random key, a scenario family or its overlay,
a resumable fold's carry, a sweep mesh spec, a language model's
parameters or a training state from the reference package's arrays into
the port.

The reference (JAX) package's arrays reach the port as numpy arrays — what
``np.asarray`` gives for them. Those are often read-only views, so they are
copied before torch takes them. A reference family or overlay is read by
its attribute names only (its fields go through ``np.asarray``), so this
module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.counterfactual import ScenarioGrid
from repro_torch.core.executor import SweepCarry
from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import AuctionRule, ScenarioOverlay
from repro_torch.device import DeviceLike, pick_device
from repro_torch.launch.mesh import SweepMeshSpec, make_mesh
from repro_torch.models.model import AnyModel, new_model


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


def key_from_reference(key_data, *, device: DeviceLike = "cpu"
                       ) -> torch.Tensor:
    """A :mod:`repro_torch.prng` key from a ``jax.random`` key's data (its
    two uint32 words, ``np.asarray(jax.random.PRNGKey(seed))``, or a batch
    of keys (..., 2)): the same words, held as int64."""
    words = np.array(key_data, dtype=np.uint32, copy=True)
    if words.shape[-1:] != (2,):
        raise ValueError(f"a threefry key has two uint32 words, got shape "
                         f"{words.shape}")
    return torch.from_numpy(words.astype(np.int64)).to(pick_device(device))


_OVERLAY_TYPES = {"live_start": np.int32, "live_stop": np.int32,
                  "bid_sigma": np.float32, "part_prob": np.float32}


def overlay_from_reference(overlay, *, device: DeviceLike = None
                           ) -> Optional[ScenarioOverlay]:
    """The port's :class:`ScenarioOverlay` of a reference overlay (anything
    with its fields ``live_start``, ``live_stop``, ``bid_sigma``,
    ``part_prob`` (numpy-convertible or None), ``key`` (the key's two
    uint32 words or None) and ``time_varying``): the same values, bit for
    bit. ``None`` gives ``None``."""
    if overlay is None:
        return None
    dev = pick_device(device)
    fields = {name: None if getattr(overlay, name) is None
              else _tensor(getattr(overlay, name), dtype, dev)
              for name, dtype in _OVERLAY_TYPES.items()}
    key = None if overlay.key is None else \
        key_from_reference(np.asarray(overlay.key), device=dev)
    return ScenarioOverlay(key=key, time_varying=bool(overlay.time_varying),
                           **fields)


def family_from_reference(family, *, device: DeviceLike = None):
    """The port's :class:`repro_torch.scenarios.CompiledFamily` of a
    reference compiled family (read by attribute: ``values``, ``grid``
    with ``rules`` (``multipliers``, ``reserve``, ``kind``), ``budgets``
    and ``labels``, ``overlay``, ``entrant_slots``, ``base_index``), so
    both packages sweep the same family."""
    from repro_torch.scenarios.family import CompiledFamily
    grid = family.grid
    values, port_grid = from_reference(
        np.asarray(family.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device=device)
    return CompiledFamily(
        values=values, grid=port_grid,
        overlay=overlay_from_reference(family.overlay, device=device),
        entrant_slots=dict(family.entrant_slots),
        base_index=int(family.base_index))


def carry_from_reference(carry, *, device: DeviceLike = None):
    """The port's :class:`~repro_torch.core.executor.SweepCarry` of a
    reference carry (read by attribute: ``s_hat``, ``active``,
    ``cap_times``, ``n_hat`` numpy-convertible, ``n_events_seen``): the
    same values, bit for bit, on ``device``."""
    dev = pick_device(device)
    return SweepCarry(
        s_hat=_tensor(carry.s_hat, np.float32, dev),
        active=_tensor(carry.active, np.bool_, dev),
        cap_times=_tensor(carry.cap_times, np.int32, dev),
        n_hat=_tensor(carry.n_hat, np.int32, dev),
        n_events_seen=int(carry.n_events_seen))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, dict):
            out.update(_flatten(sub, path + "/"))
        else:
            out[path] = np.asarray(sub)
    return out


def _reference_leaf(name: str, cfg: ArchConfig
                    ) -> Tuple[str, Optional[int], int]:
    """The reference tree path of the port's parameter ``name``, the index
    into the stacked axis it is unstacked from (None outside the stacks)
    and that axis's size: the decoder-only LM's ``groups`` (``n_groups``
    repetitions of the pattern, then the unstacked ``tail``), the
    encoder-decoder's ``enc_groups`` (``encoder_layers``) and
    ``dec_groups`` (``n_layers``)."""
    head, _, rest = name.partition(".")
    stacks = {"enc_blocks": ("enc_groups", cfg.encoder_layers),
              "dec_blocks": ("dec_groups", cfg.n_layers)}
    if head not in stacks and head != "blocks":
        return name.replace(".", "/"), None, 0
    index, _, rest = rest.partition(".")
    layer, rest = int(index), rest.replace(".", "/")
    if head in stacks:
        stack, size = stacks[head]
        return f"{stack}/{rest}", layer, size
    width = len(cfg.pattern)
    if layer < cfg.n_groups * width:
        return (f"groups/sub{layer % width}/{rest}", layer // width,
                cfg.n_groups)
    return f"tail/tail{layer - cfg.n_groups * width}/{rest}", None, 0


def _port_values(tree, cfg: ArchConfig, model) -> Dict[str, np.ndarray]:
    """The leaves of a reference tree in the layout of ``repro``'s
    ``Model.init_params`` (numpy leaves), by the name of the port's
    parameter of ``model`` each becomes: the stacked leaves unstacked into
    one block per layer. A missing, extra or misshapen leaf raises
    ``ValueError``."""
    leaves = _flatten(tree)
    used = set()
    out = {}
    for name, p in model.named_parameters():
        path, index, size = _reference_leaf(name, cfg)
        if path not in leaves:
            raise ValueError(f"the reference tree has no {path!r} for the "
                             f"port's {name}")
        value = leaves[path]
        if index is not None:
            if value.shape[:1] != (size,):
                raise ValueError(f"{path} stacks {value.shape[:1]} layers "
                                 f"or groups, the config has {size}")
            value = value[index]
        if value.shape != tuple(p.shape):
            raise ValueError(f"{path} has shape {value.shape}, the port's "
                             f"{name} {tuple(p.shape)}")
        used.add(path)
        out[name] = np.array(value, dtype=np.float32)
    # a config of fewer layers than one pattern (n_groups 0) has every
    # layer in the tail and its stacked groups empty
    extra = sorted(path for path in set(leaves) - used
                   if not (path.startswith("groups/") and cfg.n_groups == 0
                           and leaves[path].shape[:1] == (0,)))
    if extra:
        raise ValueError(f"reference leaves the port has no parameter for: "
                         f"{extra}")
    return out


def lm_params_from_reference(params, cfg: ArchConfig, *,
                             device: DeviceLike = None,
                             param_dtype: torch.dtype = torch.bfloat16
                             ) -> AnyModel:
    """The port's model of ``cfg`` (:func:`~repro_torch.models.new_model`)
    holding the reference's parameters: ``params`` is ``repro``'s tree
    from ``Model.init_params`` with numpy leaves (``np.asarray`` of each).
    The stacked leaves are unstacked into one block per layer: the
    decoder-only LM's ``groups`` (n_groups, ...) (the attention, ``moe``,
    ``mamba``, ``mlstm`` and ``slstm`` subtrees alike; the ``tail`` is
    unstacked already), the encoder-decoder's ``enc_groups``
    (encoder_layers, ...) and ``dec_groups`` (n_layers, ...); ``enc_norm``
    and the VLM's ``patch_proj/w`` are carried as they are. Each value is
    cast to the dtype the port holds it in: with ``param_dtype`` bfloat16
    (serving), the one the reference reads it at (bfloat16 matmul
    weights, as its ``cdt`` casts them; float32 norm scales, gate biases,
    ``a_log``, ``dt_bias`` and ``conv_b``); with ``torch.float32``
    (training), the reference's float32 masters unrounded. A missing,
    extra or misshapen leaf raises ``ValueError``."""
    model = new_model(cfg, device=device, param_dtype=param_dtype)
    values = _port_values(params, cfg, model)
    for name, p in model.named_parameters():
        p.data.copy_(torch.from_numpy(values[name]))
    return model


def train_state_from_reference(state, cfg: ArchConfig, *,
                               device: DeviceLike = None):
    """The port's :class:`~repro_torch.train.TrainState` of ``repro``'s
    (``params`` and the optimizer's ``mu`` and ``nu``, trees in the
    parameters' layout with numpy leaves, and its ``step``): float32
    masters and moments keyed by the port's parameter names, unstacked as
    :func:`lm_params_from_reference` unstacks them, and an int32 step, on
    ``device`` (the card by default). A train step of a model of ``cfg``
    copies the parameters into the model's own
    (:func:`repro_torch.train.bind_state`)."""
    from repro_torch.train import AdamWState, TrainState
    dev = pick_device(device)
    shape = new_model(cfg, device="meta", param_dtype=torch.float32)

    def tensors(tree):
        return {name: torch.from_numpy(v).to(dev)
                for name, v in _port_values(tree, cfg, shape).items()}

    opt = state.opt
    step = torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(params=tensors(state.params),
                      opt=AdamWState(step=step, mu=tensors(opt.mu),
                                     nu=tensors(opt.nu)))


def mesh_spec_from_reference(spec, *, devices) -> SweepMeshSpec:
    """The port's :class:`~repro_torch.launch.mesh.SweepMeshSpec` of a
    reference spec (anything with ``mesh.axis_names``, ``mesh.shape`` (a
    mapping of axis sizes), ``event_axes`` and ``scenario_axis``): the same
    axes, sizes and roles over ``devices`` (one a mesh position, row-major;
    repeats allowed, e.g. ``["cpu"] * 4``), so both packages shard the same
    rows the same way."""
    names = tuple(spec.mesh.axis_names)
    shape = tuple(int(spec.mesh.shape[a]) for a in names)
    return SweepMeshSpec(make_mesh(shape, names, devices=devices),
                         event_axes=tuple(spec.event_axes),
                         scenario_axis=spec.scenario_axis)
