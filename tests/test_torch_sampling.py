"""Sampling at ``temperature > 0``: the port's ``prng.uniform`` in
bfloat16, ``prng.gumbel`` and ``prng.categorical``, and
``ServeEngine._sample`` and ``generate``, bitwise ``jax.random``'s and
``repro.serve.engine.ServeEngine``'s on the CPU.

``repro`` samples with ``jax.random.categorical(key, logits /
temperature)`` on bfloat16 logits: the argmax of ``gumbel + logits``,
where the bfloat16 Gumbel noise comes from 8 random bits a draw (128
uniform values), so ties are common and the first index wins. Its
``_gumbel`` is a ``jax.jit`` of its own, so XLA could have kept float32
between its two logs; in this process (default XLA flags) it does not:
each ``log`` is XLA CPU's float32 log of the bfloat16 operand, rounded to
bfloat16 before the next op, and the port rounds so (one rounding at the
end instead differs in most draws).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import engine as j_engine  # noqa: E402
from repro_torch import interop, prng  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402

KEYS = 1000
TEMPERATURES = (0.5, 0.7, 1.3)
SAMPLED_ARCH = "stablelm-1.6b"
SAMPLED = ((0.7, 3), (0.7, 11))    # (temperature, key seed) of generate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n, seed=0):
    """``n`` jax keys and the port's (n, 2) batch of the same words."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, interop.key_from_reference(np.asarray(keys))


def _equal(port, want):
    np.testing.assert_array_equal(port.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(jnp.finfo(
    jnp.bfloat16).tiny), 1.0), (-1.0, 1.0), (0.3, 2.7)])
def test_bfloat16_uniform_is_jax_random(lo, hi):
    """128 values from the low byte of each word; the scale and shift
    rounded op by op (at (0.3, 2.7) a fused multiply-add would differ)."""
    jkeys, keys = _keys(KEYS)
    want = jax.vmap(lambda k: jax.random.uniform(
        k, (3, 7), jnp.bfloat16, minval=lo, maxval=hi))(jkeys)
    got = prng.uniform(keys, (3, 7), minval=lo, maxval=hi,
                       dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (KEYS, 3, 7)
    _equal(got, want)
    if (lo, hi) == (0.0, 1.0):
        assert len(np.unique(np.asarray(want, np.float32))) == 128


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gumbel_is_jax_random(dtype):
    jkeys, keys = _keys(KEYS, seed=1)
    want = jax.vmap(lambda k: jax.random.gumbel(
        k, (2, 9), getattr(jnp, dtype)))(jkeys)
    got = prng.gumbel(keys, (2, 9), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _equal(got, want)
    # and without vmap: the jitted _gumbel on one key, as serving calls it
    for i in (0, 1, KEYS - 1):
        _equal(prng.gumbel(keys[i], (2, 9), getattr(torch, dtype)),
               jax.random.gumbel(jkeys[i], (2, 9), getattr(jnp, dtype)))


def _logits(kind, vocab_pad=512):
    """(B, 1, V_pad) float32 logits: ``ties`` on a coarse grid over a
    narrow range (so that ``gumbel + logits`` ties often), ``spread`` a
    wide standard normal."""
    rng = np.random.default_rng(5)
    if kind == "ties":
        return (rng.integers(0, 6, (4, 1, vocab_pad)) / 4).astype(np.float32)
    return (rng.standard_normal((4, 1, vocab_pad)) * 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["ties", "spread"])
@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_sample_is_repros_sample(kind, temperature):
    """``ServeEngine._sample`` on the same bfloat16 logits and key: bitwise
    ``repro``'s (the logits sliced to the true vocabulary, divided by the
    temperature in bfloat16, then ``jax.random.categorical``), over 1,000
    keys at once (``jax.vmap`` of ``repro``'s ``_sample``; the port's
    draws broadcast over a (K, 2) batch of keys) and over a few keys one
    call at a time, as serving calls it. On the tied logits the largest
    ``gumbel + logits`` of a row is shared by two or more entries in many
    draws, and both take the first."""
    cfg = types.SimpleNamespace(vocab_size=500, num_patches=0)
    model = types.SimpleNamespace(cfg=cfg)
    ref = types.SimpleNamespace(model=model, temperature=temperature)
    port = ServeEngine(model, max_len=0, temperature=temperature)
    logits = _logits(kind)
    jl, tl = jnp.asarray(logits, jnp.bfloat16), torch.from_numpy(
        logits).bfloat16()
    jkeys, keys = _keys(KEYS, seed=2)
    want = np.asarray(jax.vmap(
        lambda k: j_engine.ServeEngine._sample(ref, jl, k))(jkeys))
    got = port._sample(tl, keys)
    assert got.dtype == torch.int32 and tuple(got.shape) == (KEYS, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(0, KEYS, 100):
        np.testing.assert_array_equal(
            port._sample(tl, keys[i]).numpy(),
            np.asarray(j_engine.ServeEngine._sample(ref, jl, jkeys[i])))
    assert len(np.unique(want)) > 20
    if kind == "ties":
        t = torch.tensor(temperature).bfloat16()
        scaled = tl[:, -1, :500] / t
        noisy = prng.gumbel(keys, tuple(scaled.shape), torch.bfloat16) \
            + scaled
        tied = (noisy == noisy.amax(-1, keepdim=True)).sum(-1) > 1
        assert int(tied.sum()) > KEYS // 10


def test_float32_categorical_is_jax_random():
    logits = _logits("spread")[:, 0]
    jkeys, keys = _keys(200, seed=4)
    for i in range(200):
        want = jax.random.categorical(jkeys[i], jnp.asarray(logits))
        got = prng.categorical(keys[i], torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_ignores_the_key():
    """At temperature 0 ``_sample`` is the argmax, whatever the key."""
    cfg = types.SimpleNamespace(vocab_size=500, num_patches=0)
    eng = ServeEngine(types.SimpleNamespace(cfg=cfg), max_len=0)
    tl = torch.from_numpy(_logits("spread")).bfloat16()
    want = torch.argmax(tl[:, -1, :500], -1).to(torch.int32)
    for key in (None, prng.PRNGKey(0), prng.PRNGKey(9)):
        assert torch.equal(eng._sample(tl, key), want)
    with pytest.raises(ValueError, match="needs a key"):
        ServeEngine(types.SimpleNamespace(cfg=cfg), max_len=0,
                    temperature=0.7)._sample(tl)


# ---------------------------------------------------------------------------
# generate at temperature 0.7, the whole model against repro's engine


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    """``repro``'s ``ServeEngine.generate`` at each of ``SAMPLED`` and
    greedily, on reduced stablelm-1.6b, run as
    ``tests/torch_lm_reference.py`` runs it; the port's model on the same
    parameters. Its logits are ``repro``'s on these prompts bit for bit
    but for the last bit of one small logit at one decode step (a
    last-bit difference near the top of a row could move a draw, which
    is why this is not whisper-small or internvl2-76b, whose logits carry
    the attention's roundings: ``tests/test_torch_encdec.py``)."""
    params = lm_ref.numpy_params(SAMPLED_ARCH)
    batch = lm_ref.serve_batch(SAMPLED_ARCH)
    ref = lm_ref.ServeReference(
        [(SAMPLED_ARCH, SAMPLED_ARCH, params, batch, True, SAMPLED)],
        tmp_path_factory.mktemp("sampling"))
    port = interop.lm_params_from_reference(
        params, reduced_config(SAMPLED_ARCH), device="cpu")
    return port, batch, ref.result(SAMPLED_ARCH)


@pytest.mark.parametrize("temperature,seed", SAMPLED)
def test_generate_at_temperature_is_repros(sampled, temperature, seed):
    """The same tokens as ``repro``'s ``generate`` with the same weights
    and key: the first token drawn with the key, each later one with the
    second key of a split of the previous one."""
    port, batch, ref = sampled
    eng = ServeEngine(port, max_len=lm_ref.MAX_LEN, temperature=temperature)
    tokens = lm_ref.torch_batch(batch)["tokens"]
    got = eng.generate(tokens, lm_ref.STEPS, key=prng.PRNGKey(seed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  ref[f"sampled/{temperature}/{seed}"])
    again = eng.generate({"tokens": tokens}, lm_ref.STEPS,
                         key=prng.PRNGKey(seed))
    assert torch.equal(again, got)
    # greedy tokens are the reference's greedy loop's, with or without a key
    greedy = ServeEngine(port, max_len=lm_ref.MAX_LEN)
    for key in (None, prng.PRNGKey(seed)):
        np.testing.assert_array_equal(
            greedy.generate(tokens, lm_ref.STEPS, key=key).numpy(),
            ref["tokens"])
