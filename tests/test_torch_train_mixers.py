"""Training the recurrent mixers on the CPU against ``repro``: the loss of
``Model.loss`` and the gradient of every parameter against ``repro``'s
compiled ``jax.value_and_grad`` of its ``Model.loss`` (remat off), for
jamba-v0.1-52b (one period of 8 layers: mamba with dense and MoE MLPs and
the attention layer) and xlstm-125m (one period of 6: five mLSTM blocks
and an sLSTM), reduced, B=2, S=32, from the same numpy-drawn float32
masters and ``repro``'s batch, as float32 twins and computing in
bfloat16, with ``tests/test_torch_train_loss.py``'s bounds: the loss
within 1e-6 / 1e-3 (measured 0 and 7.5e-8 / 9.8e-5 and 5.9e-5) and every
leaf's gradient within 2e-5 / 6e-2 of its scale (``max |port - repro| /
max |repro|``): jamba's, measured at most 1.6e-5 / 4.4e-2 (its bfloat16
run takes ``repro``'s MoE experts at near ties, as granite's does there).

xlstm's gradients need wider bounds, 1e-3 / 0.3 (measured 1.9e-4 /
0.15), because they are ill-conditioned at these weights and tokens, in
either package: a few (row, head) contexts of the mLSTM are near zero
(their mean square down to 6e-7, under the head norm's eps of 1e-6; the
first positions' context is ``q.k v`` over a floor when ``|q.k|`` is
small), and the head norm divides them by their own size, so every
gradient upstream of it carries their relative error amplified. Measured
on the port alone: multiplying the embedding table by ``1 +- 2^-24``
moves the float32 twin's gradients by up to 3.7e-4 of their scale, and
by ``1 +- 2^-9`` (a bfloat16 rounding of about half its entries) the
bfloat16 gradients by up to 1.5. The input gates' biases ``b_i`` have a
gradient that cancels (shifting every input gate of a unit scales the
memory's numerator and normaliser alike: exactly zero for the sLSTM,
2.6e-10 of rounding; nearly so for the mLSTM, where only its floors
break the symmetry), so they are held against their block's largest
gradient instead of their own (measured 6.1e-7 / 2.2e-3 of it).

The two autograd Functions are held in float64 against autograd of the
plain code they replace and by ``torch.autograd.gradcheck``: mamba's
``SelectiveScan`` against an out-of-place doubling scan, with a carried
state and several channel slices; the sLSTM's ``SLSTMScan`` against its
token loop, with a starting state and at a tie of its stabiliser. Also:
a mamba layer over two chunks of 1,024 against ``jax.grad`` of
``repro``'s; the recomputing forward (every block but the sLSTM's)
bitwise the plain one; the masters serving the bfloat16 models' bits;
and ``train_loop`` lowering xlstm's loss.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.data.tokens import pipeline_for as j_pipeline_for  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import pipeline_for  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import mamba as t_mamba  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402
from test_torch_train_loss import (  # noqa: E402
    BF16_GRAD_TOL, BF16_LOSS_TOL, F32_GRAD_TOL, F32_LOSS_TOL, ROUTE_DRIFT,
    _reference_compute)

B, S = 2, 32
LAYERS = {"jamba-v0.1-52b": 8, "xlstm-125m": 6}
TOLS = {"float32": (F32_LOSS_TOL, F32_GRAD_TOL),
        "bfloat16": (BF16_LOSS_TOL, BF16_GRAD_TOL)}
XLSTM_GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    """``(repro's config, the port's)``, reduced and cut to one period."""
    return (dataclasses.replace(j_reduced_config(arch),
                                n_layers=LAYERS[arch]),
            dataclasses.replace(reduced_config(arch), n_layers=LAYERS[arch]))


def port_loss_and_grads(arch, params, compute, routes=None, remat=False):
    """The port's loss, metrics and gradients by name (a leaf the loss
    never reads, the sLSTM's ``ff_norm``, has a zero gradient, as in
    ``repro``)."""
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
    grads = {name: p.grad if p.grad is not None else torch.zeros_like(p)
             for name, p in model.named_parameters()}
    return model, loss.detach(), metrics, grads


GRAD_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import reduced_config
    from repro.data.tokens import pipeline_for
    from repro.models import build_model
    B, S = %d, %d
    records = []
    top_k = jax.lax.top_k

    def recorded_top_k(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda p, i: records.append(
            (np.asarray(p), np.asarray(i))), x, idx, ordered=True)
        return vals, idx

    jax.lax.top_k = recorded_top_k

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[f"{prefix}{k}"] = np.asarray(v)
        return out

    out = {}
    for job in sys.argv[2:]:
        arch, n_layers = job.split(":")
        with np.load(f"{sys.argv[1]}/{arch}.npz") as data:
            params = {}
            for path in data.files:
                node = params
                *head, last = path.split("/")
                for k in head:
                    node = node.setdefault(k, {})
                node[last] = jnp.asarray(data[path])
        cfg = dataclasses.replace(reduced_config(arch),
                                  n_layers=int(n_layers))
        model = build_model(cfg)
        batch = pipeline_for(cfg, seq_len=S, global_batch=B,
                             seed=1).batch(0)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, remat=False), has_aux=True))
        records.clear()
        (loss, metrics), grads = grad_fn(params, batch)
        jax.effects_barrier()
        out[f"{arch}/loss"] = np.asarray(loss)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}"] = np.asarray(v)
        for k, v in flat(grads).items():
            out[f"{arch}/grads/{k}"] = v
        for j, (p, i) in enumerate(records):
            out[f"{arch}/probs/{j}"] = p
            out[f"{arch}/experts/{j}"] = i
    np.savez(f"{sys.argv[1]}/reference.npz", **out)
    print("REFERENCE_OK")
""") % (B, S)


def unflatten(flat: dict) -> dict:
    tree = {}
    for path, value in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = value
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """``repro``'s compiled ``value_and_grad`` of ``Model.loss`` per
    (arch, compute dtype), each run once: ``(params, loss, metrics,
    grads, MoE routing records)``. The bfloat16 runs are made in a
    subprocess with XLA's excess precision off (started at once), as
    ``tests/torch_lm_reference.py`` runs ``repro``'s serving: then its
    fusions round each bfloat16 op as the port's eager ops do. With it on,
    jamba's MoE probabilities drift up to 0.0135 from the port's (measured;
    ``ROUTE_DRIFT`` is 2^-7), without it 0.0009."""
    params = {arch: lm_ref.numpy_params(arch, seed=0, n_layers=n)
              for arch, n in LAYERS.items()}
    workdir = tmp_path_factory.mktemp("grad_reference")
    for arch in LAYERS:
        np.savez(workdir / f"{arch}.npz", **lm_ref._flat(params[arch]))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=lm_ref.SRC,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.Popen(
        [sys.executable, "-c", GRAD_REFERENCE, str(workdir),
         *(f"{arch}:{n}" for arch, n in LAYERS.items())], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cache = {}

    def float32_run(arch):
        j_cfg = configs(arch)[0]
        model = j_build_model(j_cfg)
        batch = j_pipeline_for(j_cfg, seq_len=S, global_batch=B,
                               seed=1).batch(0)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, b: model.loss(p, b, remat=False), has_aux=True))
        with _reference_compute(jnp.float32):
            (loss, metrics), grads = grad_fn(params[arch], batch)
        return (float(loss), metrics, jax.tree.map(np.asarray, grads),
                None)

    def bfloat16_runs():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        assert "REFERENCE_OK" in stdout
        with np.load(workdir / "reference.npz") as data:
            out = {k: data[k] for k in data.files}
        for arch in LAYERS:
            run = {k.split("/", 1)[1]: v for k, v in out.items()
                   if k.startswith(f"{arch}/")}
            calls = sum(k.startswith("probs/") for k in run)
            records = [(run[f"probs/{j}"], run[f"experts/{j}"])
                       for j in range(calls)]
            cache[arch, "bfloat16"] = (
                float(run["loss"]),
                {k[8:]: v for k, v in run.items()
                 if k.startswith("metrics/")},
                unflatten({k[6:]: v for k, v in run.items()
                           if k.startswith("grads/")}),
                records if configs(arch)[0].n_experts else None)

    def get(arch, compute):
        if (arch, compute) not in cache:
            if compute == "float32":
                cache[arch, compute] = float32_run(arch)
            else:
                bfloat16_runs()
        return (params[arch],) + cache[arch, compute]
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_loss_and_gradients_are_repros(arch, compute, reference):
    """``Model.loss`` and the gradient of every parameter against
    ``repro``'s, from the same float32 masters and batch; the MoE's aux
    loss too (jamba)."""
    params, want_loss, want_metrics, want_grads, records = reference(
        arch, compute)
    model, loss, metrics, grads = port_loss_and_grads(
        arch, params, getattr(torch, compute), routes=records)
    loss_tol, grad_tol = TOLS[compute]
    if arch == "xlstm-125m":
        grad_tol = XLSTM_GRAD_TOL[compute]
    assert abs(float(loss) - want_loss) <= loss_tol * abs(want_loss)
    assert float(metrics["tokens"]) == float(want_metrics["tokens"])
    if configs(arch)[0].n_experts:
        aux = float(want_metrics["aux"])
        assert aux > 0
        assert abs(float(metrics["aux"].detach()) - aux) <= \
            loss_tol * 10 * aux
    want = interop._port_values(want_grads, configs(arch)[1], model)
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        if not want[name].any():      # read by neither loss
            assert not g.any(), name
            continue
        scale = float(np.abs(want[name]).max())
        if name.endswith(("mlstm.b_i", "slstm.b_i")):
            block = name.rsplit(".", 2)[0]
            scale = max(float(np.abs(w).max()) for n, w in want.items()
                        if n.startswith(block + "."))
        diff = float((g - torch.from_numpy(want[name])).abs().max())
        assert diff <= grad_tol * scale, (name, diff / scale)


def test_every_leaf_but_ff_norm_gets_a_gradient(reference):
    """Every parameter of both models is read by the loss except the
    sLSTM's ``ff_norm``, which ``repro`` declares and never reads."""
    for arch in LAYERS:
        params = reference(arch, "float32")[0]
        model, *_ = port_loss_and_grads(arch, params, torch.float32)
        unread = [n for n, p in model.named_parameters() if p.grad is None]
        assert unread == (["blocks.5.slstm.ff_norm"]
                          if arch == "xlstm-125m" else []), unread


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_recomputed_blocks_give_the_same_gradients(arch, reference):
    """Per-block recomputation (``torch.utils.checkpoint``) changes no bit
    of the loss or of any gradient."""
    params = reference(arch, "float32")[0]
    _, loss, _, plain = port_loss_and_grads(arch, params, torch.bfloat16)
    _, loss_r, _, remat = port_loss_and_grads(arch, params, torch.bfloat16,
                                              remat=True)
    assert torch.equal(loss, loss_r)
    for name, g in plain.items():
        assert torch.equal(g, remat[name]), name


@pytest.mark.parametrize("arch", sorted(LAYERS))
def test_masters_serve_the_bfloat16_model(arch):
    """A model of float32 masters computes in bfloat16 and serves the
    bfloat16 model's logits and states bit for bit: every mixer's ``cdt``
    casts at use what serving holds cast already."""
    cfg = configs(arch)[1]
    params = lm_ref.numpy_params(arch, seed=0, n_layers=LAYERS[arch])
    served = interop.lm_params_from_reference(params, cfg, device="cpu")
    masters = interop.lm_params_from_reference(params, cfg, device="cpu",
                                               param_dtype=torch.float32)
    tokens = pipeline_for(cfg, seq_len=S, global_batch=B, seed=1,
                          device="cpu").batch(0)["tokens"]
    with torch.no_grad():
        a, caches_a = served.prefill(tokens, S + 1)
        b, caches_b = masters.prefill(tokens, S + 1)
        nxt = a.argmax(-1)
        a2, _ = served.decode_step(caches_a, nxt, S)
        b2, _ = masters.decode_step(caches_b, nxt, S)
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a, b) and torch.equal(a2, b2)


# ---------------------------------------------------------------------------
# the mamba scan's autograd Function

def plain_scan(dt, b_mat, c_mat, x_c, a_log, h_in):
    """The chunk's scan out of place under autograd: the doubling steps
    as new tensors, the states from ``h_in``, the C contraction."""
    a, h = t_mamba.discretise(a_log, dt, b_mat, x_c)
    t, step = a.shape[1], 1
    while step < t:
        h = torch.cat([h[:, :step], h[:, step:] + a[:, step:] * h[:, :-step]],
                      dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    h = h + a * h_in[:, None]
    y = (h.to(x_c.dtype) @ c_mat[..., None])[..., 0]
    return y, h[:, -1]


def scan_inputs(b, t, d_in, n, seed=0):
    """Float64 inputs of one chunk, a non-zero carried state among them,
    each recording gradients."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale)

    dt = torch.nn.functional.softplus(draw(b, t, d_in))
    return tuple(v.requires_grad_() for v in (
        dt, draw(b, t, n), draw(b, t, n), draw(b, t, d_in),
        draw(d_in, n, scale=0.5), draw(b, d_in, n)))


@pytest.mark.parametrize("slices", [1, 3])
@pytest.mark.parametrize("t", [1, 7, 16])
def test_selective_scan_gradient_is_a_plain_scans(monkeypatch, slices, t):
    """``SelectiveScan``'s gradient of every input is autograd's of the
    plain out-of-place scan, in float64, over 1 or 3 channel slices and a
    ragged chunk (T=7) or one step (T=1), with ``h_last`` read too."""
    b, d_in, n = 2, 6, 3
    monkeypatch.setattr(t_mamba, "SCAN_ELEMENTS", b * t * n * d_in // slices)
    assert len(t_mamba.channel_slices(b, t, d_in, n)) == slices
    inputs = scan_inputs(b, t, d_in, n, seed=t)
    rng = np.random.default_rng(99)
    gy = torch.from_numpy(rng.standard_normal((b, t, d_in)))
    gh = torch.from_numpy(rng.standard_normal((b, d_in, n)))

    def grads(fn):
        y, h = fn(*inputs)
        return torch.autograd.grad((y, h), inputs, (gy, gh)), y, h

    got, y, h = grads(t_mamba.SelectiveScan.apply)
    want, y_plain, h_plain = grads(plain_scan)
    torch.testing.assert_close(y, y_plain, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(h, h_plain, rtol=1e-12, atol=1e-12)
    for name, g, w in zip(("dt", "b", "c", "x", "a_log", "h_in"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10,
                                   msg=name)


def test_selective_scan_passes_gradcheck(monkeypatch):
    """Finite differences of ``SelectiveScan`` in float64 agree with its
    backward (2 channel slices, a carried state)."""
    b, t, d_in, n = 1, 5, 4, 2
    monkeypatch.setattr(t_mamba, "SCAN_ELEMENTS", b * t * n * 2)
    assert len(t_mamba.channel_slices(b, t, d_in, n)) == 2
    assert torch.autograd.gradcheck(t_mamba.SelectiveScan.apply,
                                    scan_inputs(b, t, d_in, n, seed=5))


def test_mamba_layer_gradients_over_two_chunks():
    """A float32 mamba layer over S=2,048 (two chunks of 1,024: the
    carried state's gradient crosses a chunk) against ``jax.grad`` of
    ``repro``'s ``mamba_apply``: the input's and every weight's gradient
    within 2e-5 of its scale (the doubling scan adds in another order
    than ``lax.associative_scan``)."""
    arch = "jamba-v0.1-52b"
    cfg, j_cfg = reduced_config(arch), j_reduced_config(arch)
    params = lm_ref.numpy_params(arch, seed=0, n_layers=8)
    p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                     params["groups"])["sub0"]["mamba"]
    x = np.random.default_rng(6).standard_normal(
        (1, 2048, cfg.d_model)).astype(np.float32)
    gy = np.random.default_rng(7).standard_normal(
        (1, 2048, cfg.d_model)).astype(np.float32)

    def j_loss(p, x):
        return jnp.sum(j_mamba.mamba_apply(p, x, j_cfg)[0] * gy)

    want_p, want_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        p, jnp.asarray(x))
    layer = t_mamba.Mamba(cfg, torch.device("cpu")).float()
    for name, v in p.items():
        getattr(layer, name).data.copy_(torch.from_numpy(np.array(v)))
        getattr(layer, name).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = t_mamba.mamba_apply(layer, xt, cfg)
    out.backward(torch.from_numpy(gy))
    assert lm_ref.rel(xt.grad, np.asarray(want_x)) <= F32_GRAD_TOL
    for name, v in want_p.items():
        assert lm_ref.rel(getattr(layer, name).grad,
                          np.asarray(v)) <= F32_GRAD_TOL, name


# ---------------------------------------------------------------------------
# the sLSTM scan's autograd Function

def slstm_inputs(dtype, seed=0, b=2, s=7, h=3, dh=4):
    """The recurrent weights, the gates' input projections and a non-zero
    starting state, each recording gradients."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).to(dtype).requires_grad_()

    return (draw(h, dh, 4 * dh, scale=0.5), draw(b, s, 4, h, dh),
            *(draw(b, h, dh, scale=0.3).abs().detach().requires_grad_()
              for _ in range(4)))


def plain_slstm(r, wx, *state):
    """The token loop under autograd, all of the Function's outputs."""
    state = t_xlstm.SLSTMState(*state)
    hids = []
    for t in range(wx.shape[1]):
        state = t_xlstm._slstm_cell(r, state, wx[:, t], r.dtype)
        hids.append(state.hid)
    return (torch.stack(hids, 1).to(r.dtype),) + tuple(state)


@pytest.mark.parametrize("s", [1, 7])
def test_slstm_scan_gradient_is_the_plain_loops(s):
    """``SLSTMScan``'s outputs are the token loop's bit for bit and its
    gradient of every input (the recurrent weights, the gates' inputs, the
    starting state) autograd's of the loop, in float64, every output's
    gradient given."""
    inputs = slstm_inputs(torch.float64, seed=s, s=s)
    got_out = t_xlstm.SLSTMScan.apply(*inputs)
    want_out = plain_slstm(*inputs)
    for a, b in zip(got_out, want_out):
        assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(9)
    cots = [torch.randn(o.shape, generator=gen, dtype=o.dtype)
            for o in got_out]
    got = torch.autograd.grad(got_out, inputs, cots)
    want = torch.autograd.grad(want_out, inputs, cots)
    for name, g, w in zip(("r", "wx", "c", "n", "hid", "m"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=name)


def test_slstm_scan_passes_gradcheck():
    assert torch.autograd.gradcheck(
        t_xlstm.SLSTMScan.apply,
        slstm_inputs(torch.float64, seed=3, b=1, s=4, h=2, dh=2))


def test_slstm_scan_splits_the_gradient_at_ties():
    """Where the stabiliser's two candidates tie (``log f + m == i``) each
    gets half of the gradient, as ``jnp.maximum`` gives it: autograd's of
    the loop, whose ``torch.maximum`` splits it so too."""
    r, wx, *state = slstm_inputs(torch.float64, seed=4, s=3)
    with torch.no_grad():
        r.zero_()                  # no recurrence: pre-activations are wx
        state[3].zero_()           # m = 0 before the first step
        # i = log_sigmoid(f) at the first step: a tie in every unit
        wx[:, 0, 1] = t_xlstm.log_sigmoid(wx[:, 0, 2])
    inputs = (r, wx, *state)
    out = t_xlstm.SLSTMScan.apply(*inputs)
    pre = wx[:, 0]
    assert torch.equal(t_xlstm.log_sigmoid(pre[:, 2]) + state[3], pre[:, 1])
    got = torch.autograd.grad(out[0].sum(), inputs)
    want = torch.autograd.grad(plain_slstm(*inputs)[0].sum(), inputs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


def test_train_loop_lowers_xlstms_loss(tmp_path):
    """``launch.train.train_loop`` trains reduced xlstm-125m (both mixers,
    per-block recompute) on the CPU: 12 steps reduce the loss."""
    cfg = configs("xlstm-125m")[1]
    _, losses = train_loop(cfg, steps=12, global_batch=4, seq_len=32,
                           ckpt_dir=tmp_path, lr=3e-3, ckpt_every=100,
                           log_every=100, device="cpu")
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
