"""The port's training path (``repro_torch.train``, ``data.tokens``,
``fault``, ``launch.train``) against ``repro``'s on the CPU, and its resume
and restart bit for bit within the port.

Bounds, where not bitwise (``max |port - repro| / max |repro|`` over a
tensor unless said):

* ``softmax_xent``: rtol 1e-6 (the logsumexp's float32 sum runs in another
  order);
* ``AdamW.update``: bitwise (the norm, the moments and the parameters in
  XLA CPU's float32 order, found in its optimised HLO) for vector leaves,
  and for any leaves unclipped; for leaves of several dims XLA's last
  small reduction of the norm takes a shape-dependent order, so with
  clipping the norm is within a float32 ulp and the update within 1e-6;
* ``warmup_cosine``: within one float32 ulp (rtol 3e-7): the port repeats
  XLA's folded form, but ``torch.cos`` is not XLA's ``cos``;
* ``TokenPipeline.batch``: bitwise;
* a train step from ``train_state_from_reference``, float32 twins
  (``repro``'s ``COMPUTE_DTYPE`` patched to float32): loss and grad norm
  within 1e-6, the moments within 2e-5 (``nu`` holds squares) and the
  parameters within 1e-6 (measured 3e-7, 3e-6 and 2.3e-7); computing in
  bfloat16: the loss and grad norm within 1e-3, the moments within 5e-2
  and the parameters within 1e-2 (measured 3.5e-5, 7.2e-4, 1.2e-2 and
  2.9e-3: bfloat16 gradients move Adam's second step by up to 1.6 steps
  where a gradient is near zero);
* ``plan_remesh``, ``StragglerPolicy``, ``StepWatchdog``: ``repro``'s
  answers.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.encdec as j_encdec  # noqa: E402
import repro.models.layers as j_layers  # noqa: E402
import repro.models.lm as j_lm  # noqa: E402
from repro import fault as j_fault  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.data.tokens import pipeline_for as j_pipeline_for  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models.layers import softmax_xent as j_softmax_xent  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_train_step  # noqa: E402
from repro_torch import fault, interop, train  # noqa: E402
from repro_torch.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data import TokenPipeline, pipeline_for  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import new_model  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402

ARCH = "stablelm-1.6b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_softmax_xent_is_repros(dtype):
    """A padded vocabulary (columns past ``true_vocab`` masked) and labels
    of -1 (not counted)."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 40)) * 4).astype(np.float32)
    labels = rng.integers(0, 33, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 6] = -1
    want, want_n = j_softmax_xent(jnp.asarray(logits, getattr(jnp, dtype)),
                                  jnp.asarray(labels), 33)
    got, n = softmax_xent(torch.from_numpy(logits).to(getattr(torch, dtype)),
                          torch.from_numpy(labels), 33)
    assert got.dtype == torch.float32 and float(n) == float(want_n) == 17
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _trees(seed, gscale, shapes):
    rng = np.random.default_rng(seed)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    m = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (np.abs(rng.normal(size=s)) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * gscale).astype(np.float32)
         for k, s in shapes.items()}
    return p, m, v, g


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


VECTORS = {"a": (8192,), "b": (4773,), "c": (31,)}
ARRAYS = {"a": (8192,), "b": (37, 129), "c": (3, 5, 70)}


@pytest.mark.parametrize("shapes,gscale", [
    (VECTORS, 1e-3), (VECTORS, 1.0), (ARRAYS, 1e-3), (ARRAYS, 1.0)])
def test_adamw_update_is_repros(shapes, gscale):
    """Bitwise where the norms agree: always for vector leaves, and for
    any leaves when the gradients are not clipped (gscale 1e-3: norm < 1,
    scale exactly 1). Leaves of several dims with clipping: the norm
    within a float32 ulp, the rest within 1e-6."""
    p, m, v, g = _trees(3, gscale, shapes)
    j_adamw = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(3e-4, 5, 100))
    want_p, want_s, want_met = jax.jit(j_adamw.update)(
        g, j_opt.AdamWState(step=jnp.int32(6), mu=m, nu=v), p)
    adamw = train.AdamW(learning_rate=train.warmup_cosine(3e-4, 5, 100))
    got_p, got_s, got_met = adamw.update(
        _torch(g), train.AdamWState(torch.tensor(6, dtype=torch.int32),
                                    _torch(m), _torch(v)), _torch(p))
    bitwise = shapes is VECTORS or gscale < 1
    np.testing.assert_allclose(float(got_met["grad_norm"]),
                               float(want_met["grad_norm"]),
                               rtol=0 if bitwise else 2.4e-7)
    assert float(got_met["lr"]) == float(want_met["lr"])
    assert int(got_s.step) == int(want_s.step) == 7
    assert got_s.step.dtype == torch.int32
    tol = 0 if bitwise else 1e-6
    for k in p:
        for got, want in ((got_p[k], want_p[k]), (got_s.mu[k], want_s.mu[k]),
                          (got_s.nu[k], want_s.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=tol, atol=0)


def test_adamw_init_and_global_norm():
    p, _, _, g = _trees(4, 1.0, VECTORS)
    state = train.AdamW(train.constant_lr(1e-3)).init(_torch(p))
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    assert all(float(t.abs().sum()) == 0 and t.dtype == torch.float32
               for t in (*state.mu.values(), *state.nu.values()))
    want = jax.jit(j_opt.global_norm)(g)
    assert float(train.global_norm(_torch(g))) == float(want)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 5, 100),
                                               (3e-4, 20, 100),
                                               (1e-3, 1, 7)])
def test_warmup_cosine_is_repros(peak, warmup, total):
    want_fn = jax.jit(j_opt.warmup_cosine(peak, warmup, total))
    got_fn = train.warmup_cosine(peak, warmup, total)
    steps = range(0, total + 30)
    want = np.array([np.float32(want_fn(jnp.int32(i))) for i in steps])
    got = np.array([got_fn(torch.tensor(i, dtype=torch.int32)).item()
                    for i in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    assert float(train.constant_lr(3e-3)(torch.tensor(4))) == \
        float(j_opt.constant_lr(3e-3)(jnp.int32(4)))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-76b",
                                  "whisper-small"])
def test_token_batches_are_repros_bits(arch):
    """Text, a patch prefix (bfloat16 ``patch_embeds``) and frames
    (bfloat16 ``frames``), at two steps; the iterator gives the same."""
    want_pipe = j_pipeline_for(j_reduced_config(arch), seq_len=32,
                               global_batch=3, seed=5)
    pipe = pipeline_for(reduced_config(arch), seq_len=32, global_batch=3,
                        seed=5, device="cpu")
    for step in (0, 11):
        want, got = want_pipe.batch(step), pipe.batch(step)
        assert sorted(want) == sorted(got)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k]
            if k in ("tokens", "labels"):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), w)
            else:
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(g.float().numpy(),
                                              w.astype(np.float32))
    first = next(iter(pipe))
    assert torch.equal(first["tokens"], pipe.batch(0)["tokens"])


def test_token_pipeline_padded_zipf_is_repros():
    """A vocabulary of more than one window of 32 and a ragged last one:
    the Zipf sum in XLA's windows."""
    from repro.data.tokens import TokenPipeline as JPipe
    want = JPipe(1001, 16, 2, seed=9, zipf_a=1.1).batch(3)
    got = TokenPipeline(1001, 16, 2, seed=9, zipf_a=1.1,
                        device="cpu").batch(3)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


@contextlib.contextmanager
def _reference_compute(dtype):
    mods = (j_layers, j_lm, j_encdec)
    saved = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, saved):
            m.COMPUTE_DTYPE = d


STEP_TOLS = {   # compute: loss and grad norm, moments, parameters
    "float32": (1e-6, 2e-5, 1e-6),
    "bfloat16": (1e-3, 5e-2, 1e-2),
}


@pytest.mark.parametrize("compute,microbatches", [("float32", 1),
                                                  ("float32", 2),
                                                  ("bfloat16", 1)])
def test_train_step_is_repros(compute, microbatches):
    """``repro`` takes one step from numpy-drawn masters; its state goes
    to the port by ``train_state_from_reference``; both take the next
    step on batch 1 and their states and metrics agree."""
    params = lm_ref.numpy_params(ARCH, seed=0)
    j_model = j_build_model(j_reduced_config(ARCH))
    j_adamw = j_opt.AdamW(learning_rate=j_opt.warmup_cosine(1e-3, 2, 10))
    j_pipe = j_pipeline_for(j_reduced_config(ARCH), seq_len=32,
                            global_batch=4, seed=1)
    j_step = jax.jit(j_train_step.make_train_step(
        j_model, j_adamw, microbatches=microbatches))
    with _reference_compute(getattr(jnp, compute)):
        state = j_train_step.TrainState(params=params,
                                        opt=j_adamw.init(params))
        state, _ = j_step(state, j_pipe.batch(0))
        start = jax.tree.map(np.asarray, state)
        want, want_met = j_step(state, j_pipe.batch(1))

    cfg = reduced_config(ARCH)
    model = new_model(cfg, device="cpu", param_dtype=torch.float32)
    if compute == "float32":
        model.compute_dtype = None
    adamw = train.AdamW(learning_rate=train.warmup_cosine(1e-3, 2, 10))
    step = train.make_train_step(model, adamw, microbatches=microbatches)
    got, met = step(interop.train_state_from_reference(start, cfg,
                                                       device="cpu"),
                    pipeline_for(cfg, seq_len=32, global_batch=4, seed=1,
                                 device="cpu").batch(1))
    metric_tol, moment_tol, param_tol = STEP_TOLS[compute]
    expected = {"loss", "grad_norm", "lr"} | (
        {"ce", "aux", "tokens"} if microbatches == 1 else set())
    assert set(met) == set(want_met) == expected
    for k in ("loss", "grad_norm"):
        assert abs(float(met[k]) - float(want_met[k])) <= \
            metric_tol * abs(float(want_met[k])), k
    np.testing.assert_allclose(float(met["lr"]), float(want_met["lr"]),
                               rtol=3e-7)
    assert int(got.opt.step) == int(want.opt.step) == 2
    assert all(got.params[n] is p for n, p in model.named_parameters())
    shape = new_model(cfg, device="meta", param_dtype=torch.float32)
    for part, tol in (("params", param_tol), ("mu", moment_tol),
                      ("nu", moment_tol)):
        tree = want.params if part == "params" else getattr(want.opt, part)
        ref = interop._port_values(jax.tree.map(np.asarray, tree), cfg,
                                   shape)
        mine = got.params if part == "params" else getattr(got.opt, part)
        for name, value in ref.items():
            assert lm_ref.rel(mine[name].detach(), value) <= tol, \
                (part, name)


def _setup(seed=0, microbatches=1):
    cfg = reduced_config(ARCH)
    model = new_model(cfg, device="cpu", param_dtype=torch.float32)
    adamw = train.AdamW(learning_rate=train.constant_lr(1e-3))
    state = train.init_state(model, adamw, seed)
    step = train.make_train_step(model, adamw, microbatches=microbatches)
    pipe = pipeline_for(cfg, seq_len=16, global_batch=4, seed=42,
                        device="cpu")
    return cfg, model, adamw, state, step, pipe


def _snapshot(state):
    return {"params": {k: v.detach().clone()
                       for k, v in state.params.items()},
            "mu": {k: v.clone() for k, v in state.opt.mu.items()},
            "nu": {k: v.clone() for k, v in state.opt.nu.items()},
            "step": int(state.opt.step)}


def _assert_same(a, b):
    assert a["step"] == b["step"]
    for part in ("params", "mu", "nu"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def test_resume_is_bit_identical(tmp_path):
    """train(5) == train(3) -> checkpoint -> restore into a new model ->
    train(2)."""
    _, _, _, s, step, pipe = _setup()
    for i in range(5):
        s, _ = step(s, pipe.batch(i))
    straight = _snapshot(s)

    _, _, _, s, step, pipe = _setup()
    for i in range(3):
        s, _ = step(s, pipe.batch(i))
    save_checkpoint(tmp_path / "ck", 3, s)
    _, model, adamw, fresh, step, pipe = _setup(seed=7)
    restored, manifest = restore_checkpoint(tmp_path / "ck", fresh,
                                            device="cpu")
    assert manifest["step"] == 3 and int(restored.opt.step) == 3
    s = train.bind_state(model, restored)
    assert all(s.params[n] is p for n, p in model.named_parameters())
    for i in range(manifest["step"], 5):
        s, _ = step(s, pipe.batch(i))
    _assert_same(straight, _snapshot(s))


def test_microbatches_split_the_rows():
    """Two microbatches of a batch: the mean of their losses and of their
    gradients, which one microbatch of the same rows also gives to within
    float32 (one rounding of the sum and of the halving)."""
    _, _, _, s1, step1, pipe = _setup()
    _, _, _, s2, step2, _ = _setup(microbatches=2)
    s1, m1 = step1(s1, pipe.batch(0))
    s2, m2 = step2(s2, pipe.batch(0))
    assert set(m2) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=2e-2)


def test_train_loop_restart_is_the_uninterrupted_run(tmp_path):
    """A ``WorkerFailure`` at step 3 restores step 2's checkpoint: the
    losses from there on and the final state are an uninterrupted run's
    bit for bit."""
    cfg = reduced_config(ARCH)
    kw = dict(steps=6, global_batch=2, seq_len=16, ckpt_every=2,
              log_every=100, lr=1e-3, device="cpu")
    state, losses = train_loop(cfg, ckpt_dir=tmp_path / "a", **kw)
    want = _snapshot(state)
    state, restarted = train_loop(
        cfg, ckpt_dir=tmp_path / "b",
        failure_injector=fault.FailureInjector(schedule={3: 0}), **kw)
    # steps 0-2 ran, step 3 failed, the restart resumed at step 2
    assert restarted[:3] == losses[:3] and restarted[3:] == losses[2:]
    _assert_same(want, _snapshot(state))
    # a later call resumes from the last checkpoint and has nothing to do
    _, more = train_loop(cfg, ckpt_dir=tmp_path / "b", **kw)
    assert more == []


def test_train_loop_gives_up_after_max_restarts(tmp_path):
    class Always(fault.FailureInjector):
        def check(self, step):
            raise fault.WorkerFailure(step, 1)

    cfg = reduced_config(ARCH)
    with pytest.raises(fault.WorkerFailure):
        train_loop(cfg, steps=2, global_batch=2, seq_len=8,
                   ckpt_dir=tmp_path, failure_injector=Always(),
                   max_restarts=0, device="cpu")


def test_loss_decreases_in_training():
    """25 steps on the synthetic token stream reduce the loss (as
    ``tests/test_archs_smoke.py``'s test of ``repro``)."""
    cfg = reduced_config(ARCH)
    model = new_model(cfg, device="cpu", param_dtype=torch.float32)
    adamw = train.AdamW(learning_rate=train.constant_lr(3e-3),
                        weight_decay=0.0)
    state = train.init_state(model, adamw, 0)
    step = train.make_train_step(model, adamw)
    pipe = pipeline_for(cfg, seq_len=32, global_batch=8, device="cpu")
    losses = []
    for i in range(25):
        state, metrics = step(state, pipe.batch(i))
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


@pytest.mark.parametrize("args", [(192, 16, 256, 4, 16), (8, 2, 12, 3, 4),
                                  (7, 1, 64, 1, 8), (16, 4, 30, 2, 8)])
def test_plan_remesh_is_repros(args):
    want = j_fault.plan_remesh(*args)
    got = fault.plan_remesh(*args)
    assert (got.mesh_shape, got.axis_names, got.microbatches) == \
        (want.mesh_shape, want.axis_names, want.microbatches)
    mesh = fault.build_mesh(got, devices=["cpu"] * int(np.prod(
        got.mesh_shape)))
    assert mesh.shape == dict(zip(got.axis_names, got.mesh_shape))
    with pytest.raises(ValueError):
        fault.plan_remesh(8, 16, 256, 4, 16)


def test_straggler_policy_and_watchdog_are_repros():
    rng = np.random.default_rng(0)
    times = [[1.0 + rng.normal() * 0.01 + (3.0 if w in (2, 5) else 0.0)
              for w in range(8)] for _ in range(12)]
    for window, k_mad in ((8, 4.0), (4, 6.0), (16, 50.0)):
        want = j_fault.StragglerPolicy(window=window, k_mad=k_mad)
        got = fault.StragglerPolicy(window=window, k_mad=k_mad)
        for row in times:
            for w, t in enumerate(row):
                want.record(w, t)
                got.record(w, t)
        assert got.stragglers() == want.stragglers()
    ticks = iter([0.0, 2.5, 10.0, 10.5])
    wd = fault.StepWatchdog(deadline_s=1.0, clock=lambda: next(ticks))
    assert wd.run(lambda x: x + 1, 1) == (2, 2.5, True)
    assert wd.run(lambda: "ok") == ("ok", 0.5, False)
    inj = fault.FailureInjector(rate=0.5, seed=3, n_workers=16)
    j_inj = j_fault.FailureInjector(rate=0.5, seed=3, n_workers=16)
    for step in range(20):
        outcomes = []
        for injector in (inj, j_inj):
            try:
                injector.check(step)
                outcomes.append(None)
            except (fault.WorkerFailure, j_fault.WorkerFailure) as e:
                outcomes.append((e.step, e.worker))
        assert outcomes[0] == outcomes[1]
