"""The port's last serving paths against ``repro``'s, on the CPU, with
``repro``'s parameters carried across (``interop.lm_params_from_reference``)
at ``reduced_config``: whisper-small's encoder-decoder (2 encoder and 2
decoder layers, 12 frames) and internvl2-76b's patch prefix (4 patches
ahead of the text).

The whole models are held against ``repro`` run as
``tests/torch_lm_reference.py`` runs it (``ServeReference``: XLA's excess
precision off, the flash fast path in interpret mode, which takes
``causal=False`` for whisper's encoder), in one subprocess for this file,
on the same prompts, frames and patch embeddings from seeded numpy:

* prefill logits and the 8 greedy decode steps' logits within
  ``FAST_PATH_TOL`` of their scale (``tests/test_torch_lm.py``'s bound),
  not bitwise: the port's CPU attention is the flash kernel's plain
  version (a full softmax, then the product with v), the reference's the
  Pallas kernel (the product with v, then the division by the
  normaliser), and the two round a bfloat16 output the other way now and
  then (measured here: whisper 0.0045-0.0075 of the scale, internvl2
  0-0.0056); the greedy tokens equal;
* the decode caches: the cross keys and values are exactly
  ``repro``'s ``_cross_kv`` of the same encoder output (bitwise, below),
  and within two bfloat16 ulps at their scale (``TWO_ULPS``, ``max|port -
  repro| / max|repro| <= 2^-6``) of the reference's prefill caches, whose
  encoder output carries the attention's roundings (measured: 0.0039 to
  0.0053, under one ulp); the self-attention caches likewise (whisper 0
  and up to 2^-7 in its second layer, internvl2 0 to 0.002).

The layers are held op by op against ``repro`` run eagerly
(``jax.disable_jit``): cross-attention and the patch projection bitwise,
the encoder within ``TWO_ULPS`` (measured: one ulp of its largest
value, 0.0051 of the scale).
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
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models.spec import count_params  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import (EncDecModel, Model, build_model,  # noqa: E402
                                new_model)
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402

FAST_PATH_TOL = 1.5e-2
TWO_ULPS = 2.0 ** -6
ARCHS = ("whisper-small", "internvl2-76b")
B, S, MAX_LEN, STEPS = lm_ref.B, lm_ref.S, lm_ref.MAX_LEN, lm_ref.STEPS
_rel = lm_ref.rel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """Per arch: the config, ``repro``'s parameters (numpy), the port's
    model holding them and the serving batch (numpy)."""
    out = {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        params = lm_ref.numpy_params(arch)
        port = interop.lm_params_from_reference(params, cfg, device="cpu")
        out[arch] = (cfg, params, port, lm_ref.serve_batch(arch))
    return out


@pytest.fixture(scope="module")
def reference(pairs, tmp_path_factory):
    jobs = [(arch, arch, params, batch, True, [])
            for arch, (_, params, _, batch) in pairs.items()]
    return lm_ref.ServeReference(jobs, tmp_path_factory.mktemp("encdec"))


def _clone(caches):
    return [type(c)(*(_clone([x])[0] if isinstance(x, tuple) else x.clone()
                      for x in c)) for c in caches]


@pytest.fixture(scope="module", params=ARCHS)
def served(request, pairs, reference):
    """The port's greedy loop on the batch: every step's logits, the
    prefill's caches (cloned before decode writes into them), the tokens;
    and ``repro``'s."""
    arch = request.param
    cfg, params, port, batch = pairs[arch]
    tb = lm_ref.torch_batch(batch)
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    logits, caches = port.prefill(tb["tokens"], MAX_LEN, **extra)
    prefill_caches = _clone(caches)
    steps, tokens = [logits], []
    start = S + cfg.num_patches
    for i in range(STEPS):
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)
        tokens.append(tok.numpy().astype(np.int32))
        logits, caches = port.decode_step(caches, tok[:, None], start + i)
        steps.append(logits)
    return dict(arch=arch, cfg=cfg, params=params, port=port, batch=batch,
                steps=steps, caches=prefill_caches, final_caches=caches,
                tokens=np.stack(tokens, 1), ref=reference.result(arch))


def test_prefill_and_decode_logits_match_repro(served):
    cfg = served["cfg"]
    for i, logits in enumerate(served["steps"]):
        assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
        assert logits.dtype == torch.bfloat16
        assert _rel(logits, served["ref"][f"logits/{i}"]) < FAST_PATH_TOL, \
            (served["arch"], i)


def test_greedy_tokens_match_repro(served):
    assert np.array_equal(served["tokens"], served["ref"]["tokens"]), \
        served["arch"]


def test_engine_generate_is_the_greedy_loop(served):
    """``ServeEngine.generate`` on ``repro``'s batch (a dict with the stub
    frontend's input) gives the greedy loop's tokens; its positions count
    the patches."""
    eng = ServeEngine(served["port"], max_len=MAX_LEN)
    got = eng.generate(lm_ref.torch_batch(served["batch"]), STEPS)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), served["tokens"]), served["arch"]


def test_decode_caches_match_repro(served):
    """Each layer's self-attention cache (its max_len positions, the
    patches' included) within two bfloat16 ulps at its scale of
    ``repro``'s; whisper's cross keys and values too, bfloat16, (B, F, KV,
    dh), and unchanged by the decode steps."""
    cfg, ref = served["cfg"], served["ref"]
    for j, cache in enumerate(served["caches"]):
        kv = cache.self_kv if cfg.is_encdec else cache
        named = dict(k=kv.k, v=kv.v)
        if cfg.is_encdec:
            named.update(cross_k=cache.cross_k, cross_v=cache.cross_v)
            assert tuple(cache.cross_k.shape) == (
                B, cfg.encoder_frames, cfg.n_kv_heads, cfg.d_head)
            final = served["final_caches"][j]
            assert torch.equal(final.cross_k, cache.cross_k)
            assert torch.equal(final.cross_v, cache.cross_v)
        assert tuple(kv.k.shape) == (B, MAX_LEN, cfg.n_kv_heads, cfg.d_head)
        for name, got in named.items():
            want = ref[f"caches/{j}/{name}"]
            assert got.dtype == torch.bfloat16
            assert _rel(got, want) <= TWO_ULPS, (served["arch"], j, name)
        # the prefill filled S + P positions, the rest are zero
        assert not kv.k[:, S + cfg.num_patches:].any()


# ---------------------------------------------------------------------------
# the layers, op by op against repro run eagerly


def _close(port, want):
    """Within two bfloat16 ulps at the tensor's scale."""
    want = np.asarray(want, np.float32)
    err = np.max(np.abs(port.float().numpy() - want))
    assert err <= TWO_ULPS * np.max(np.abs(want)), err


def _jparams(params):
    return jax.tree.map(jnp.asarray, params)


def test_encoder_is_repro_with_its_fast_path(pairs, monkeypatch):
    """The encoder's bidirectional attention through the flash path
    (``causal=False``) against ``repro``'s ``encode`` with its fast path
    engaged, op by op: within two bfloat16 ulps at its scale."""
    cfg, params, port, batch = pairs["whisper-small"]
    monkeypatch.setattr(j_attention, "causal_attention", j_flash)
    with jax.disable_jit():
        want = j_encdec.encode(_jparams(params), j_reduced_config(
            "whisper-small"), jnp.asarray(batch["frames"]))
    got = t_encdec.encode(port, torch.from_numpy(batch["frames"]))
    assert got.dtype == torch.bfloat16
    _close(got, want)


def test_cross_attention_is_repro_bitwise(pairs):
    """``cross_kv`` and ``cross_attend`` on the same bfloat16 encoder
    output and queries: bitwise ``repro``'s ``_cross_kv`` and
    ``_cross_attend`` run op by op (bfloat16 ``q * scale`` and scores, a
    float32 softmax, bfloat16 probabilities)."""
    cfg, params, port, _ = pairs["whisper-small"]
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((B, cfg.encoder_frames, cfg.d_model)).astype(
        np.float32)
    x = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    ref_cfg = j_reduced_config("whisper-small")
    for layer in range(cfg.n_layers):
        p = jax.tree.map(lambda a: jnp.asarray(a[layer]),
                         params["dec_groups"]["xattn"])
        block = port.dec_blocks[layer].xattn
        with jax.disable_jit():
            k, v = j_encdec._cross_kv(p, jnp.asarray(enc, jnp.bfloat16),
                                      ref_cfg)
            out = j_encdec._cross_attend(p, jnp.asarray(x, jnp.bfloat16), k,
                                         v, ref_cfg)
        tk, tv = t_encdec.cross_kv(block, torch.from_numpy(enc).bfloat16())
        got = t_encdec.cross_attend(block, torch.from_numpy(x).bfloat16(),
                                    tk, tv, cfg)
        for a, b in ((tk, k), (tv, v), (got, out)):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_patch_prefix_is_repro_bitwise(pairs):
    """internvl2's prefix: the patch embeddings projected by
    ``patch_proj.w`` in bfloat16, bitwise ``repro``'s einsum; the prefix
    leads the token embeddings and the prefill's positions count it."""
    cfg, params, port, batch = pairs["internvl2-76b"]
    pe = batch["patch_embeds"]
    with jax.disable_jit():
        want = jnp.einsum("bpd,de->bpe", jnp.asarray(pe, jnp.bfloat16),
                          jnp.asarray(params["patch_proj"]["w"],
                                      jnp.bfloat16))
    got = torch.from_numpy(pe).bfloat16() @ port.patch_proj.w
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    tb = lm_ref.torch_batch(batch)
    _, caches = port.prefill(tb["tokens"], MAX_LEN,
                             patch_embeds=tb["patch_embeds"])
    filled = S + cfg.num_patches
    assert bool(caches[0].k[:, filled - 1].any())
    assert not caches[0].k[:, filled:].any()


# ---------------------------------------------------------------------------
# the port's own invariants


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch, pairs):
    """decode(pos) after prefill ~= the next prefill's last position
    (``tests/test_archs_smoke.py:60``'s bound)."""
    cfg, _, port, batch = pairs[arch]
    tb = lm_ref.torch_batch(batch)
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    toks = tb["tokens"]
    full, _ = port.prefill(toks, MAX_LEN, **extra)
    _, caches = port.prefill(toks[:, :-1], MAX_LEN, **extra)
    step, _ = port.decode_step(caches, toks[:, -1:],
                               S - 1 + cfg.num_patches)
    assert _rel(step, full.float().numpy()) < 0.15
    assert bool(torch.isfinite(step.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_build_with_the_references_parameters(arch):
    """At full width (on the meta device: no memory) the model holds as
    many parameters as ``repro``'s spec tree (whisper-small 334,674,432,
    internvl2-76b 70,620,815,360 with its 80 layers)."""
    model = new_model(get_config(arch), device="meta")
    specs = j_build_model(j_get_config(arch)).param_specs()
    assert sum(p.numel() for p in model.parameters()) == count_params(specs)
    assert isinstance(model, EncDecModel) == (arch == "whisper-small")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_seeded_and_scaled(arch):
    """``build_model`` on the CPU: seeded, norms ones in float32, matmul
    weights bfloat16 with std 1/sqrt(fan_in) (``patch_proj.w`` and the
    cross-attention's ``wq`` too), zero caches of the reference's
    shapes."""
    cfg = reduced_config(arch)
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3)
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), name
        if name.endswith("scale"):
            assert x.dtype == torch.float32 and bool((x == 1).all()), name
        else:
            assert x.dtype == torch.bfloat16, name
    w = (a.patch_proj.w if cfg.num_patches
         else a.dec_blocks[1].xattn.wq).float()
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    caches = a.init_cache(3, 20)
    assert len(caches) == cfg.n_layers
    if cfg.is_encdec:
        assert tuple(caches[0].cross_k.shape) == (3, cfg.encoder_frames,
                                                  cfg.n_kv_heads, cfg.d_head)
        assert tuple(caches[0].self_kv.k.shape) == (3, 20, cfg.n_kv_heads,
                                                    cfg.d_head)
        assert not any(c.cross_k.any() or c.self_kv.v.any() for c in caches)
    else:
        assert not any(c.k.any() for c in caches)


# ---------------------------------------------------------------------------
# what raises


def test_a_prefill_without_its_stub_input_raises(pairs):
    """No silent text-only prefill: whisper without ``frames`` and
    internvl2 without ``patch_embeds`` raise ``ValueError``, and so does a
    patch prefix given to a model without one."""
    toks = torch.zeros((B, S), dtype=torch.long)
    with pytest.raises(ValueError, match="frames="):
        pairs["whisper-small"][2].prefill(toks, MAX_LEN)
    with pytest.raises(ValueError, match="patch_embeds="):
        pairs["internvl2-76b"][2].prefill(toks, MAX_LEN)
    with pytest.raises(ValueError, match="no patch embeddings"):
        build_model(reduced_config("stablelm-1.6b"), device="cpu").prefill(
            toks, MAX_LEN, patch_embeds=torch.zeros((B, 4, 64)))
    with pytest.raises(ValueError, match="encoder-decoder"):
        Model(reduced_config("whisper-small"), device="cpu")


def test_unserved_encoder_decoder_layers_raise():
    """``repro``'s encoder-decoder reads neither the pattern nor patches:
    an encoder-decoder config with another layer kind or a patch prefix is
    refused, not served as plain attention."""
    base = reduced_config("whisper-small")
    for change in (dict(num_patches=4), dict(tie_embeddings=True),
                   dict(pattern=(dataclasses.replace(base.pattern[0],
                                                     moe=True),))):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            build_model(dataclasses.replace(base, **change), device="cpu")


def test_carry_over_checks_the_new_subtrees(pairs):
    """The stacked ``enc_groups`` and ``dec_groups`` are unstacked into one
    block per layer, ``enc_norm`` and ``patch_proj/w`` carried as they
    are; a missing, extra or misshapen leaf raises ``ValueError``."""
    cfg, params, port, _ = pairs["whisper-small"]
    np.testing.assert_array_equal(
        port.dec_blocks[1].xattn.wv.float().numpy(),
        np.asarray(jnp.asarray(params["dec_groups"]["xattn"]["wv"][1],
                               jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(
        port.enc_blocks[1].attn.wo.float().numpy(),
        np.asarray(jnp.asarray(params["enc_groups"]["attn"]["wo"][1],
                               jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(port.enc_norm.scale.numpy(),
                                  params["enc_norm"]["scale"])
    missing = jax.tree.map(lambda a: a, params)
    del missing["enc_norm"]
    with pytest.raises(ValueError, match="no 'enc_norm/scale'"):
        interop.lm_params_from_reference(missing, cfg, device="cpu")
    stacked = jax.tree.map(lambda a: a, params)
    stacked["dec_groups"]["ln_x"]["scale"] = np.ones((3, 64), np.float32)
    with pytest.raises(ValueError, match="stacks"):
        interop.lm_params_from_reference(stacked, cfg, device="cpu")
    vcfg, vparams, vport, _ = pairs["internvl2-76b"]
    np.testing.assert_array_equal(
        vport.patch_proj.w.float().numpy(),
        np.asarray(jnp.asarray(vparams["patch_proj"]["w"], jnp.bfloat16),
                   np.float32))
    wrong = jax.tree.map(lambda a: a, vparams)
    wrong["patch_proj"]["w"] = np.zeros((64, 32), np.float32)
    with pytest.raises(ValueError, match="patch_proj/w has shape"):
        interop.lm_params_from_reference(wrong, vcfg, device="cpu")
    extra = jax.tree.map(lambda a: a, params)
    extra["patch_proj"] = {"w": np.zeros((64, 64), np.float32)}
    with pytest.raises(ValueError, match="patch_proj/w"):
        interop.lm_params_from_reference(extra, cfg, device="cpu")
