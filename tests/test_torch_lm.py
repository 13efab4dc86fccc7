"""The port's LM serving path against ``repro``'s, on the CPU, with
``repro``'s parameters carried across (``interop.lm_params_from_reference``).

``repro``'s ``causal_attention`` rounds scores and probabilities to
bfloat16; the port's prefill attention on the CPU is the flash-attention
kernel's plain version (float32 inside, as ``repro``'s Pallas kernel). So the slice is held two
ways, each with the scale-aware error ``max|port - repro| / max|repro|``
of ``tests/test_archs_smoke.py:84``:

1. against ``repro`` with its documented fast path engaged
   (``repro.models.attention.causal_attention`` monkeypatched to
   ``repro.kernels.flash_attention.flash_attention`` inside the test) and
   run op by op (``jax.disable_jit``), so that every bfloat16 op rounds as
   the port's eager ops do: within ``FAST_PATH_TOL``. Measured on these
   inputs: 0 (bitwise) for stablelm-1.6b; 0.0057 prefill and 0.0068 decode
   for gemma3-4b, where one transcendental's last float32 bit first moves
   a bfloat16 rounding at layer 8 of 16.
2. against ``repro`` as it is, compiled (XLA keeps excess float32 precision
   inside its fusions): within ``AS_IS_TOL``, tighter than that file's
   0.15. Measured: 0.0068 and 0.0069 (stablelm-1.6b prefill, decode);
   0.0101 and 0.0096 (gemma3-4b).

Greedy tokens are equal both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.models.attention as j_attention  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced_config  # noqa: E402
from repro_torch.configs.base import LayerSpec  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import Model, build_model  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

FAST_PATH_TOL = 1.5e-2
AS_IS_TOL = 3e-2
SERVED = ("stablelm-1.6b", "gemma3-4b")
B, S, MAX_LEN, STEPS = 2, 12, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(port, want):
    a = np.asarray(want, np.float32)
    b = port.float().numpy() if isinstance(port, torch.Tensor) else \
        np.asarray(port, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9))


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def _pair(cfg_port, cfg_ref):
    """``repro``'s model and parameters, and the port's model holding the
    same parameters."""
    j_model = j_build_model(cfg_ref)
    params = j_model.init_params(jax.random.PRNGKey(0))
    port = interop.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg_port, device="cpu")
    return j_model, params, port


def _greedy(prefill, decode, toks, vocab):
    """``repro``'s ``ServeEngine.generate`` loop, greedy, through the given
    prefill and decode steps; returns (prefill logits, first decode
    logits, tokens (B, STEPS))."""
    first, caches = prefill(toks)
    logits, out, decode_logits = first, [], None
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1, :vocab], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, caches = decode(caches, tok[:, None],
                                jnp.int32(toks.shape[1] + i))
        decode_logits = logits if decode_logits is None else decode_logits
    return first, decode_logits, np.stack(out, 1)


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    """Per arch: the port's outputs and ``repro``'s, both ways, on the
    same prompts: the prefill logits, the first greedy decode step's
    logits and STEPS greedy tokens."""
    arch = request.param
    cfg = reduced_config(arch)
    j_model, params, port = _pair(cfg, j_reduced_config(arch))
    toks = _tokens(cfg, S)
    t_toks = torch.from_numpy(toks).long()
    port_prefill, caches = port.prefill(t_toks, MAX_LEN)
    first = torch.argmax(port_prefill[:, -1, :cfg.vocab_size], -1)
    port_decode, _ = port.decode_step(caches, first[:, None], S)
    port_tokens = t_engine.ServeEngine(port, max_len=MAX_LEN).generate(
        t_toks, STEPS).numpy()
    # as it is: the engine's own compiled steps, and its generate
    eng = j_engine.ServeEngine(j_model, params, max_len=MAX_LEN)
    as_is = _greedy(lambda t: eng._prefill(params, {"tokens": t}),
                    lambda c, t, p: eng._decode(params, c, t, p),
                    jnp.asarray(toks), cfg.vocab_size)
    engine_tokens = np.asarray(eng.generate({"tokens": jnp.asarray(toks)},
                                            STEPS))
    # the fast path, op by op
    patched = pytest.MonkeyPatch()
    patched.setattr(j_attention, "causal_attention", j_flash)
    try:
        with jax.disable_jit():
            fast = _greedy(
                lambda t: j_model.prefill(params, {"tokens": t}, MAX_LEN),
                lambda c, t, p: j_model.decode_step(params, c, t, p),
                jnp.asarray(toks), cfg.vocab_size)
    finally:
        patched.undo()
    return dict(arch=arch, cfg=cfg, engine_tokens=engine_tokens,
                port=(port_prefill, port_decode, port_tokens),
                as_is=as_is, fast=fast)


@pytest.mark.parametrize("way,tol", [("fast", FAST_PATH_TOL),
                                     ("as_is", AS_IS_TOL)])
def test_prefill_and_decode_logits_match_repro(served, way, tol):
    port_prefill, port_decode, _ = served["port"]
    want_prefill, want_decode, _ = served[way]
    cfg = served["cfg"]
    assert tuple(port_prefill.shape) == (B, 1, cfg.padded_vocab)
    assert tuple(port_decode.shape) == (B, 1, cfg.padded_vocab)
    assert port_prefill.dtype == torch.bfloat16
    assert _rel(port_prefill, want_prefill[:, -1:]) < tol, served["arch"]
    assert _rel(port_decode, want_decode) < tol, served["arch"]


@pytest.mark.parametrize("way", ["fast", "as_is"])
def test_greedy_tokens_match_repro(served, way):
    tokens = served["port"][2]
    assert tokens.shape == (B, STEPS) and tokens.dtype == np.int32
    assert np.array_equal(tokens, served[way][2]), served["arch"]
    assert np.array_equal(tokens, served["engine_tokens"]), served["arch"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_config_is_repro_field_by_field(arch):
    port, ref = reduced_config(arch), j_reduced_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.padded_vocab, port.n_groups, len(port.tail)) == \
        (ref.padded_vocab, ref.n_groups, len(ref.tail))
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))


def test_tied_embeddings_unembed_through_the_embedding_table():
    cfg = dataclasses.replace(reduced_config("stablelm-1.6b"),
                              tie_embeddings=True)
    ref_cfg = dataclasses.replace(j_reduced_config("stablelm-1.6b"),
                                  tie_embeddings=True)
    j_model, params, port = _pair(cfg, ref_cfg)
    assert not hasattr(port, "unembed")
    toks = _tokens(cfg, S)
    got, _ = port.prefill(torch.from_numpy(toks).long(), MAX_LEN)
    want, _ = j_model.prefill(params, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    assert _rel(got, want) < AS_IS_TOL


# ---------------------------------------------------------------------------
# layers, one by one, on the same bfloat16 inputs


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _equal(port, want):
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(want, np.float32))


def _close(port, want):
    """Within one bfloat16 rounding at the tensor's scale. Where two terms
    of size ~1 cancel, a last float32 bit (a matmul's accumulation order,
    RoPE's sin and cos) can move a small bfloat16 result by many of its
    own ulps, though never beyond this."""
    want = np.asarray(want, np.float32)
    err = np.max(np.abs(port.float().numpy() - want))
    assert err <= 2.0 ** -8 * np.max(np.abs(want)), err


def test_rmsnorm_and_qk_norm_are_repro():
    rng = np.random.default_rng(0)
    xj, xt = _bf16(rng.standard_normal((2, 9, 64)).astype(np.float32) * 3)
    scale = rng.standard_normal(64).astype(np.float32)
    _equal(t_layers.rmsnorm(torch.from_numpy(scale), xt, 1e-6),
           j_layers.rmsnorm({"scale": jnp.asarray(scale)}, xj, 1e-6))
    hj, ht = _bf16(rng.standard_normal((2, 9, 4, 32)).astype(np.float32))
    _equal(t_layers.rmsnorm_head(torch.from_numpy(scale[:32]), ht),
           j_layers.rmsnorm_head(jnp.asarray(scale[:32]), hj))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_is_repro(theta):
    rng = np.random.default_rng(1)
    xj, xt = _bf16(rng.standard_normal((2, 40, 4, 32)).astype(np.float32))
    pos = np.arange(40)[None] + 1000
    _close(t_layers.rope(xt, torch.from_numpy(pos), theta),
           j_layers.rope(xj, jnp.asarray(pos), theta))
    # float32 angles and rotation: within two float32 ulps of the result
    x32 = rng.standard_normal((1, 40, 2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        t_layers.rope(torch.from_numpy(x32), torch.from_numpy(pos),
                      theta).numpy(),
        np.asarray(j_layers.rope(jnp.asarray(x32), jnp.asarray(pos), theta)),
        rtol=0, atol=1e-5)


def test_mlp_is_repro():
    """SwiGLU in bfloat16, with the reference's op-by-op rounding of
    ``jax.nn.silu`` (``F.silu`` would round a third of the activations
    the other way)."""
    rng = np.random.default_rng(2)
    xj, xt = _bf16(rng.standard_normal((2, 9, 64)).astype(np.float32))
    shapes = dict(wi_gate=(64, 128), wi_up=(64, 128), wo=(128, 64))
    w = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in shapes.items()}
    mod = t_layers.MLP(64, 128, torch.device("cpu"))
    for k, v in w.items():
        getattr(mod, k).data.copy_(torch.from_numpy(v))
    with jax.disable_jit():
        want = j_layers.mlp({k: jnp.asarray(v) for k, v in w.items()}, xj)
    _close(t_layers.mlp(mod, xt), want)


@pytest.fixture(scope="module")
def gemma_pair():
    cfg = reduced_config("gemma3-4b")
    return (cfg, j_reduced_config("gemma3-4b")) + _pair(
        cfg, j_reduced_config("gemma3-4b"))


@pytest.mark.parametrize("layer", [0, 5])     # a window-8 and a global layer
def test_attend_full_is_repro_with_its_fast_path(gemma_pair, layer,
                                                 monkeypatch):
    cfg, ref_cfg, j_model, params, port = gemma_pair
    monkeypatch.setattr(j_attention, "causal_attention", j_flash)
    rng = np.random.default_rng(layer)
    xj, xt = _bf16(rng.standard_normal((B, 20, cfg.d_model))
                   .astype(np.float32))
    p = jax.tree.map(lambda a: a[0], params["groups"])[f"sub{layer}"]
    spec = ref_cfg.pattern[layer]
    with jax.disable_jit():
        out, (k, v) = j_attention.attend_full(
            p["attn"], xj, ref_cfg, spec, jnp.arange(20)[None])
    got, (tk, tv) = t_attention.attend_full(
        port.blocks[layer].attn, xt, cfg, port.blocks[layer].spec,
        torch.arange(20)[None])
    _close(tk, k)
    _close(tv, v)
    _close(got, out)


@pytest.mark.parametrize("layer", [0, 5])
def test_attend_decode_is_repro(gemma_pair, layer):
    """A rolling window-8 cache (layer 0) and a global one (layer 5),
    decoding past the window's wrap: the same cache slots written, each
    value within one bfloat16 rounding."""
    cfg, ref_cfg, j_model, params, port = gemma_pair
    rng = np.random.default_rng(10 + layer)
    p = jax.tree.map(lambda a: a[0], params["groups"])[f"sub{layer}"]
    spec = ref_cfg.pattern[layer]
    s_cache = min(16, spec.window) if spec.window else 16
    kv0 = rng.standard_normal((2, B, s_cache, cfg.n_kv_heads, cfg.d_head))
    cache_j = j_attention.KVCache(*(jnp.asarray(a, jnp.bfloat16)
                                    for a in kv0))
    cache_t = t_attention.KVCache(*(torch.from_numpy(a).bfloat16()
                                    for a in kv0))
    for pos in (3, 11, 13):
        xj, xt = _bf16(rng.standard_normal((B, 1, cfg.d_model))
                       .astype(np.float32))
        with jax.disable_jit():
            out, cache_j = j_attention.attend_decode(
                p["attn"], xj, ref_cfg, spec, cache_j, jnp.int32(pos))
        got, cache_t = t_attention.attend_decode(
            port.blocks[layer].attn, xt, cfg, port.blocks[layer].spec,
            cache_t, pos)
        _close(got, out)
        _close(cache_t.k, cache_j.k)
        _close(cache_t.v, cache_j.v)


@pytest.mark.parametrize("s", [5, 8, 19])
def test_prefill_cache_rolls_as_repro(s):
    """Window 8: the last 8 positions, position p in slot p % 8; a global
    layer pads to max_len."""
    rng = np.random.default_rng(s)
    k, v = rng.standard_normal((2, 2, s, 2, 4)).astype(np.float32)
    cfg = j_reduced_config("gemma3-4b")
    for spec in (cfg.pattern[0], cfg.pattern[5]):
        want = j_attention.prefill_cache(cfg, spec, jnp.asarray(k),
                                         jnp.asarray(v), 24)
        got = t_attention.prefill_cache(
            LayerSpec(window=spec.window), torch.from_numpy(k),
            torch.from_numpy(v), 24)
        _equal(got.k, want.k)
        _equal(got.v, want.v)


# ---------------------------------------------------------------------------
# the port's own invariants (tests/test_archs_smoke.py:60,94)


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_consistency(arch):
    """decode(pos=S) after prefill(S) ~= prefill(S+1)'s last position."""
    cfg = reduced_config(arch)
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, S + 1)).long()
    full, _ = model.prefill(toks, MAX_LEN)
    _, caches = model.prefill(toks[:, :S], MAX_LEN)
    step, _ = model.decode_step(caches, toks[:, S:], S)
    assert _rel(step, full.float().numpy()) < 0.15
    assert torch.isfinite(step.float()).all()


def test_decode_cache_exactness():
    """The decode-updated cache equals the full prefill's cache at the
    written position."""
    cfg = reduced_config("stablelm-1.6b")
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, S + 1)).long()
    _, full = model.prefill(toks, MAX_LEN)
    _, pre = model.prefill(toks[:, :S], MAX_LEN)
    _, dec = model.decode_step(pre, toks[:, S:], S)
    np.testing.assert_allclose(dec[0].k[:, :S + 1].float().numpy(),
                               full[0].k[:, :S + 1].float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_init_params_is_seeded_and_scaled():
    cfg = reduced_config("gemma3-4b")
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3)
    c = build_model(cfg, device="cpu", seed=4)
    for (name, x), y, z in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(x, y), name
        if name.endswith(("scale", "q_norm", "k_norm")):
            assert x.dtype == torch.float32 and bool((x == 1).all()), name
        else:
            assert x.dtype == torch.bfloat16 and not torch.equal(x, z), name
    assert abs(float(a.embed.table.float().std()) - 1.0) < 0.05
    wq = a.blocks[0].attn.wq.float()
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    caches = a.init_cache(3, 20)
    assert len(caches) == cfg.n_layers
    assert tuple(caches[0].k.shape) == (3, 8, cfg.n_kv_heads, cfg.d_head)
    assert tuple(caches[5].k.shape) == (3, 20, cfg.n_kv_heads, cfg.d_head)
    assert not any(c.k.any() or c.v.any() for c in caches)


# ---------------------------------------------------------------------------
# the budget planner (numpy, copied)


def test_planner_is_repro():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64):
        budgets = rng.integers(4, 300, size=n)
        exits = t_engine.estimate_exit_steps(budgets, eos_survival=0.99,
                                             key=np.random.default_rng(n))
        want = j_engine.estimate_exit_steps(budgets, eos_survival=0.99,
                                            key=np.random.default_rng(n))
        np.testing.assert_array_equal(exits, want)
        for k in (1, 3, 4):
            plan = t_engine.plan_compactions(exits, max_segments=k)
            ref = j_engine.plan_compactions(want, max_segments=k)
            assert (plan.compaction_points, plan.segments) == \
                (ref.compaction_points, ref.segments)
            true = np.minimum(budgets, rng.geometric(0.01, size=n))
            assert t_engine.wasted_slot_steps(plan, true) == \
                j_engine.wasted_slot_steps(ref, true)


# ---------------------------------------------------------------------------
# boundaries: what raises, and the carry-over's checks


@pytest.mark.parametrize("change,what", [
    (dict(pattern=(LayerSpec(moe=True),), n_experts=4, top_k=2), "MoE"),
    (dict(pattern=(LayerSpec(kind="mamba"),)), "mamba"),
    (dict(pattern=(LayerSpec(kind="mlstm"), LayerSpec(kind="slstm"))),
     "mlstm/slstm"),
])
def test_ported_layer_kinds_build_and_prefill(change, what):
    """The MoE MLP and the mamba, mLSTM and sLSTM mixers (which raised
    until the port ran them) build on the CPU and prefill."""
    cfg = dataclasses.replace(reduced_config("stablelm-1.6b"), **change)
    model = build_model(cfg, device="cpu")
    logits, caches = model.prefill(
        torch.from_numpy(_tokens(cfg, S)).long(), MAX_LEN)
    assert tuple(logits.shape) == (B, 1, cfg.padded_vocab), what
    assert bool(torch.isfinite(logits.float()).all()), what
    assert len(caches) == cfg.n_layers


@pytest.mark.parametrize("change,what", [
    pytest.param(dict(encoder_layers=2, encoder_frames=12),
                 "frames", id="change3-encoder-decoder"),
    pytest.param(dict(num_patches=4), "patch_embeds", id="change4-VLM"),
])
def test_unported_architectures_raise(change, what):
    """The encoder-decoder and the VLM's patch prefix (which raised until
    the port ran them) build on the CPU and prefill with their stub
    frontend's input; what raises now is a prefill without it
    (``ValueError``: no silent text-only prefill)."""
    cfg = dataclasses.replace(reduced_config("stablelm-1.6b"), **change)
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, S)).long()
    width = cfg.encoder_frames or cfg.num_patches
    stub = torch.randn((B, width, cfg.d_model),
                       generator=torch.Generator().manual_seed(0))
    logits, caches = model.prefill(toks, MAX_LEN, **{what: stub})
    assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())
    assert len(caches) == cfg.n_layers
    with pytest.raises(ValueError, match=f"{what}="):
        model.prefill(toks, MAX_LEN)


def test_unported_modes_raise():
    """What raised until the port ran it runs: train mode of a recurrent
    mixer (which raised until the port trained mamba, the mLSTM and the
    sLSTM: ``tests/test_torch_train_mixers.py``) gives every position's
    logits; sampling at ``temperature > 0`` (which raised until the port
    drew ``jax.random.categorical``'s bits) samples, and whisper-small
    (unknown to the registry until the port ran it) is a config."""
    cfg = reduced_config("xlstm-125m")
    recurrent = build_model(cfg, device="cpu")
    logits, aux = t_lm.forward(recurrent, torch.zeros(1, 4, dtype=torch.long),
                               mode="train")
    assert tuple(logits.shape) == (1, 4, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all()) and float(aux) == 0
    cfg = reduced_config("stablelm-1.6b")
    model = build_model(cfg, device="cpu")
    eng = t_engine.ServeEngine(model, max_len=16, temperature=0.7)
    toks = eng.generate(torch.from_numpy(_tokens(cfg, 6)).long(), 4)
    assert tuple(toks.shape) == (B, 4) and bool((toks < cfg.vocab_size).all())
    assert get_config("whisper-small").encoder_layers == 12
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-medium")


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_model(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Model(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve_cli.main(["--reduced"])


def test_carry_over_checks_names_and_shapes():
    cfg = reduced_config("gemma3-4b")
    params = jax.tree.map(np.asarray, j_build_model(
        j_reduced_config("gemma3-4b")).init_params(jax.random.PRNGKey(0)))
    model = interop.lm_params_from_reference(params, cfg, device="cpu")
    # layer 13 is the tail's second layer; layer 7 is group 1's sub1
    np.testing.assert_array_equal(
        model.blocks[13].attn.wk.float().numpy(),
        np.asarray(jnp.asarray(params["tail"]["tail1"]["attn"]["wk"],
                               jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(
        model.blocks[7].mlp.wo.float().numpy(),
        np.asarray(jnp.asarray(params["groups"]["sub1"]["mlp"]["wo"][1],
                               jnp.bfloat16), np.float32))
    missing = jax.tree.map(lambda a: a, params)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="no 'final_norm/scale'"):
        interop.lm_params_from_reference(missing, cfg, device="cpu")
    extra = jax.tree.map(lambda a: a, params)
    extra["patch_proj"] = {"w": np.zeros((64, 64), np.float32)}
    with pytest.raises(ValueError, match="patch_proj/w"):
        interop.lm_params_from_reference(extra, cfg, device="cpu")
    wrong = jax.tree.map(lambda a: a, params)
    wrong["embed"]["table"] = np.zeros((256, 64), np.float32)
    with pytest.raises(ValueError, match="embed/table has shape"):
        interop.lm_params_from_reference(wrong, cfg, device="cpu")
    stacked = jax.tree.map(lambda a: a, params)
    stacked["groups"]["sub0"]["ln1"]["scale"] = np.ones((3, 64), np.float32)
    with pytest.raises(ValueError, match="stacks"):
        interop.lm_params_from_reference(stacked, cfg, device="cpu")


def test_the_serve_command_runs_on_the_cpu(capsys):
    toks = serve_cli.main(["--reduced", "--device", "cpu", "--requests", "3",
                           "--prompt-len", "6", "--max-new", "8"])
    assert toks.shape[0] == 3 and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < 512)).all())
    assert "segment 0 on cpu" in capsys.readouterr().out
