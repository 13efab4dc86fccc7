"""The port's training loss and gradients against ``repro``'s on the CPU:
``Model.loss`` and the gradient of every parameter against
``jax.value_and_grad`` of ``repro``'s ``Model.loss`` (compiled), for
stablelm-1.6b, gemma3-4b (its first 6 layers: a period of 5 window layers
and a global one), granite-moe-3b-a800m,
whisper-small and internvl2-76b (reduced configs, B=2, S=32, the same
numpy-drawn float32 masters and ``repro``'s token batch), twice:
computing in bfloat16, as both packages train, and as float32 twins
(``repro``'s ``COMPUTE_DTYPE`` patched to float32 for the test, the
port's ``compute_dtype`` left to its float32 weights).

The bounds, each ``max |port - repro| / max |repro|`` over a tensor:

* the float32 twins: the loss within 1e-6 and every leaf's gradient within
  2e-5 (measured <= 3.4e-6);
* bfloat16: the loss within 1e-3 (measured <= 6e-4) and every leaf's
  gradient within 6e-2 (measured <= 3.3e-2), except gemma3-4b's QK-norm
  scales, within 1.5e-1 (measured 7.6e-2 at 16 layers: their gradient is
  a sum over every head and position of products that nearly cancel, so
  bfloat16's one-ulp moves of the terms reach it at full size). Where two
  bfloat16 runs differ by a rounding, two MoE experts whose probabilities
  lie within that drift can swap: granite's bfloat16 run takes
  ``repro``'s experts at such near ties (``moe.follow_routing``, at most
  2^-7 apart, recorded from ``repro`` by ``jax.debug.callback``), and its
  float32 twins need none.

``remat`` is off on both sides for the comparison (one MoE call a layer to
record); a separate test holds the port's recomputing forward (per-block
``torch.utils.checkpoint``) bitwise to the plain one.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.encdec as j_encdec  # noqa: E402
import repro.models.layers as j_layers  # noqa: E402
import repro.models.lm as j_lm  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.data.tokens import pipeline_for as j_pipeline_for  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import pipeline_for  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402

B, S = 2, 32
ARCHS = ("stablelm-1.6b", "gemma3-4b", "granite-moe-3b-a800m",
         "whisper-small", "internvl2-76b")
LAYERS = {"gemma3-4b": 6}
ROUTE_DRIFT = 2.0 ** -7
F32_LOSS_TOL, F32_GRAD_TOL = 1e-6, 2e-5
BF16_LOSS_TOL, BF16_GRAD_TOL, QK_NORM_TOL = 1e-3, 6e-2, 1.5e-1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    """``(repro's config, the port's)``, reduced and cut to ``LAYERS``."""
    j_cfg, t_cfg = j_reduced_config(arch), reduced_config(arch)
    if arch in LAYERS:
        j_cfg = dataclasses.replace(j_cfg, n_layers=LAYERS[arch])
        t_cfg = dataclasses.replace(t_cfg, n_layers=LAYERS[arch])
    return j_cfg, t_cfg


@contextlib.contextmanager
def _reference_compute(dtype):
    """``repro``'s models computing in ``dtype`` while the context is
    open (their ``COMPUTE_DTYPE``, read when a step is traced)."""
    mods = (j_layers, j_lm, j_encdec)
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d


@contextlib.contextmanager
def _recorded_top_k(records):
    """Every ``jax.lax.top_k`` of a step traced in the context appends its
    (probabilities, experts) to ``records`` when the step runs."""
    top_k = jax.lax.top_k

    def recorded(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda p, i: records.append(
            (np.array(p), np.array(i))), x, idx, ordered=True)
        return vals, idx

    jax.lax.top_k = recorded
    try:
        yield
    finally:
        jax.lax.top_k = top_k


def reference_loss_and_grads(arch, params, compute, records=None):
    """``repro``'s compiled ``value_and_grad`` of ``Model.loss`` (remat
    off) on its batch 0 of seed 1: ``(loss, metrics, grads)``."""
    j_cfg = configs(arch)[0]
    model = j_build_model(j_cfg)
    batch = j_pipeline_for(j_cfg, seq_len=S, global_batch=B,
                           seed=1).batch(0)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, remat=False), has_aux=True))
    recording = (_recorded_top_k(records) if records is not None
                 else contextlib.nullcontext())
    with _reference_compute(compute), recording:
        (loss, metrics), grads = grad_fn(params, batch)
        jax.effects_barrier()
    return float(loss), metrics, jax.tree.map(np.asarray, grads)


def port_loss_and_grads(arch, params, compute, routes=None, remat=False):
    cfg = configs(arch)[1]
    model = interop.lm_params_from_reference(params, cfg, device="cpu",
                                             param_dtype=torch.float32)
    if compute == torch.float32:
        model.compute_dtype = None
    for p in model.parameters():
        p.requires_grad_(True)
    batch = pipeline_for(cfg, seq_len=S, global_batch=B, seed=1,
                         device="cpu").batch(0)
    following = (t_moe.follow_routing(routes, ROUTE_DRIFT)
                 if routes is not None else contextlib.nullcontext())
    with following:
        loss, metrics = model.loss(batch, remat=remat)
    loss.backward()
    return model, loss.detach(), metrics


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_are_repros(arch, compute):
    """``Model.loss`` and the gradient of every parameter against
    ``repro``'s, from the same float32 masters and batch; the MoE's aux
    loss too (granite)."""
    params = lm_ref.numpy_params(arch, seed=0, n_layers=LAYERS.get(arch))
    moe = j_reduced_config(arch).n_experts > 0
    records = [] if (moe and compute == "bfloat16") else None
    want_loss, want_metrics, want_grads = reference_loss_and_grads(
        arch, params, getattr(jnp, compute), records)
    model, loss, metrics = port_loss_and_grads(
        arch, params, getattr(torch, compute), routes=records)
    loss_tol, grad_tol = ((F32_LOSS_TOL, F32_GRAD_TOL)
                          if compute == "float32"
                          else (BF16_LOSS_TOL, BF16_GRAD_TOL))
    assert abs(float(loss) - want_loss) <= loss_tol * abs(want_loss)
    assert float(metrics["tokens"]) == float(want_metrics["tokens"])
    if moe:
        aux = float(want_metrics["aux"])
        assert aux > 0
        assert abs(float(metrics["aux"].detach()) - aux) <= \
            loss_tol * 10 * aux
    want = interop._port_values(want_grads, configs(arch)[1], model)
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        tol = grad_tol
        if compute == "bfloat16" and name.endswith(("q_norm", "k_norm")):
            tol = QK_NORM_TOL
        assert lm_ref.rel(p.grad, want[name]) <= tol, name


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-small"])
def test_recomputed_blocks_give_the_same_gradients(arch):
    """Per-block recomputation (``torch.utils.checkpoint``) changes no bit
    of the loss or of any gradient."""
    params = lm_ref.numpy_params(arch, seed=0)
    plain, loss, _ = port_loss_and_grads(arch, params, torch.bfloat16)
    remat, loss_r, _ = port_loss_and_grads(arch, params, torch.bfloat16,
                                           remat=True)
    assert torch.equal(loss, loss_r)
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 remat.named_parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_masters_serve_the_bfloat16_model():
    """A model of float32 masters computes in bfloat16 and serves the
    bfloat16 model's logits bit for bit (``cdt`` casts at use what
    serving holds cast already)."""
    arch = "internvl2-76b"
    cfg = reduced_config(arch)
    params = lm_ref.numpy_params(arch, seed=0)
    served = interop.lm_params_from_reference(params, cfg, device="cpu")
    masters = interop.lm_params_from_reference(params, cfg, device="cpu",
                                               param_dtype=torch.float32)
    assert masters.dtype == served.dtype == torch.bfloat16
    assert masters.embed.table.dtype == torch.float32
    batch = pipeline_for(cfg, seq_len=S, global_batch=B, seed=1,
                         device="cpu").batch(0)
    with torch.no_grad():
        a, _ = served.prefill(batch["tokens"], S,
                              patch_embeds=batch["patch_embeds"])
        b, _ = masters.prefill(batch["tokens"], S,
                               patch_embeds=batch["patch_embeds"])
    assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
