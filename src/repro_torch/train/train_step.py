"""The training step: loss, gradients, AdamW, with microbatch accumulation
(port of ``repro.train.train_step``).

The model holds its weights (float32 masters, ``param_dtype=torch.float32``
of :func:`repro_torch.models.new_model`); :class:`TrainState` holds those
very tensors by name (``params``) and the optimizer's state. The step
``step(state, batch) -> (state, metrics)`` takes the gradient of
``model.loss`` with autograd and updates the parameters and moments in
place (the reference's jitted step returns new arrays in their buffers).
A state whose tensors are not the model's own (a restored checkpoint) is
copied into the model's parameters first.

Microbatches are contiguous slices of the batch's rows: their gradients
are summed in float32 (the parameters' ``.grad``) and divided by their
number, as is the loss; the metrics are then ``loss``, ``grad_norm`` and
``lr`` only, as the reference's scan drops ``ce`` and ``aux``. A leaf the
loss never reads (the sLSTM's ``ff_norm``, which ``repro`` declares and
its block does not use) gets the reference's zero gradient.
:func:`state_specs` is the train state as ``meta`` tensors, which the dry
run (:mod:`repro_torch.launch.dryrun`) runs a step on.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.train.optimizer import AdamW, AdamWState

Params = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: Params          # the model's parameters by name
    opt: AdamWState


def state_specs(model) -> TrainState:
    """The train state of ``model`` as ``meta`` tensors (``repro``'s
    ``state_specs``, ``train_step.py:31-42``, unstacked: one leaf a
    parameter of the port's): float32 masters ``params``, the moments
    ``mu`` and ``nu`` keyed like them, and an int32 ``step``."""
    meta = torch.device("meta")

    def leaves() -> Params:
        return {name: torch.empty(p.shape, dtype=torch.float32, device=meta)
                for name, p in model.named_parameters()}
    return TrainState(params=leaves(), opt=AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=meta), mu=leaves(),
        nu=leaves()))


def init_state(model, optimizer: AdamW, seed: int) -> TrainState:
    """The model's weights drawn from ``seed`` (``model.init_params``) and
    a fresh optimizer state; the parameters start recording gradients."""
    model.init_params(seed)
    return bind_state(model, None, optimizer)


def bind_state(model, state, optimizer: AdamW = None) -> TrainState:
    """A :class:`TrainState` over ``model``'s own parameter tensors: with
    ``state`` given (e.g. restored from a checkpoint) its parameter values
    are copied into the model's and its optimizer state kept, else a fresh
    optimizer state from ``optimizer``. Every parameter records
    gradients."""
    params = dict(model.named_parameters())
    for name, p in params.items():
        p.requires_grad_(True)
        if state is not None and state.params[name] is not p:
            with torch.no_grad():
                p.copy_(state.params[name])
    opt = optimizer.init(params) if state is None else state.opt
    return TrainState(params=params, opt=opt)


def make_train_step(model, optimizer: AdamW, microbatches: int = 1,
                    aux_weight: float = 0.01):
    """Returns ``step(state, batch) -> (state, metrics)``: ``batch`` a dict
    of tensors with the batch on their first axis (``tokens``, ``labels``
    and the stub frontend's ``patch_embeds`` or ``frames``); ``metrics``
    ``loss``, ``grad_norm``, ``lr`` and, with one microbatch, ``ce``,
    ``aux`` and ``tokens``, float32 tensors."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        state = bind_state(model, state)
        params = state.params
        for p in params.values():
            p.grad = None
        rows = next(iter(batch.values())).shape[0]
        mb = rows // microbatches
        loss = 0.0
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            mb_loss, metrics = model.loss(part, aux_weight=aux_weight)
            mb_loss.backward()          # adds into .grad in float32
            loss = loss + mb_loss.detach()
        for p in params.values():
            if p.grad is None:          # a leaf the loss never reads
                p.grad = torch.zeros_like(p)
        if microbatches == 1:
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss = loss / microbatches
            for p in params.values():
                p.grad.div_(microbatches)
            metrics = {}
        grads = {k: p.grad for k, p in params.items()}
        _, opt, opt_metrics = optimizer.update(grads, state.opt, params)
        for p in params.values():
            p.grad = None
        return TrainState(params=params, opt=opt), {"loss": loss,
                                                     **opt_metrics,
                                                     **metrics}

    return step
