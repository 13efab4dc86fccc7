"""The port's common random numbers against ``repro`` and ``jax``, bit for
bit: ``prng.normal`` over 2^20 keys (and ``jax.lax.erf_inv`` under it),
XLA CPU's float32 ``log1p`` and ``exp`` over 2^20 inputs, the bid noise
``v * exp(sigma * z)`` as repro's fused expression computes it, every
``core.crn`` draw at any event slice and whatever the block, and the
``crn`` kernels' plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import crn as jcrn  # noqa: E402
from repro_torch import floats, prng  # noqa: E402
from repro_torch.core import crn  # noqa: E402
from repro_torch.interop import key_from_reference  # noqa: E402
from repro_torch.kernels import crn as crn_ops  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _partitionable():
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", before)


DRAWS = 1 << 20


def _bits_equal(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    differ = want.view(np.int32) != got.view(np.int32)
    assert not differ.any(), (
        f"{int(differ.sum())} of {want.size} differ; first at "
        f"{np.argwhere(differ)[:3].tolist()}: {want[differ][:3]} vs "
        f"{got[differ][:3]}")


def _key(seed):
    return key_from_reference(np.asarray(jax.random.PRNGKey(seed)))


def test_normal_over_two_to_the_twenty_keys():
    """One draw of each of 2^20 keys, as ``event_campaign_normals`` draws
    them (``jax.random.normal(k, ())`` vmapped)."""
    keys = jax.random.split(jax.random.PRNGKey(9), DRAWS)
    want = jax.jit(jax.vmap(lambda k: jax.random.normal(k, ())))(keys)
    _bits_equal(want, prng.normal(key_from_reference(np.asarray(keys)), ()))


@pytest.mark.parametrize("shape", [(DRAWS,), (3, 5), ()])
def test_normal_of_one_key(shape):
    want = jax.random.normal(jax.random.PRNGKey(5), shape)
    _bits_equal(want, prng.normal(_key(5), shape))


def test_erf_inv_and_its_tails():
    """Both of XLA's polynomials (w < 5 and the tails), the end points and
    the float32 grid next to them."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1, 1, DRAWS // 4).astype(np.float32),
        1 - rng.uniform(0, 1e-3, DRAWS // 4).astype(np.float32),
        np.float32([-1, 1, 0, np.nextafter(np.float32(-1), np.float32(0))])])
    _bits_equal(jax.jit(jax.lax.erf_inv)(x),
                prng.erf_inv(torch.from_numpy(x)))


@pytest.mark.parametrize("lo,hi", [(-1, 0), (-0.5, 0.5), (-0.99, 30.0)])
def test_log1p_is_xla_cpus(lo, hi):
    x = np.random.default_rng(1).uniform(lo, hi, DRAWS).astype(np.float32)
    _bits_equal(jax.jit(jnp.log1p)(x), floats.log1p(torch.from_numpy(x)))


def test_log1p_special_values():
    x = np.float32([-1, -2, np.inf, np.nan, 0, -0.0, 1e-30, -0.41421356,
                    0.41421356])
    want = np.asarray(jax.jit(jnp.log1p)(x))
    got = floats.log1p(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    _bits_equal(want[ok], got[ok])


@pytest.mark.parametrize("lo,hi", [(-4, 4), (-87.5, 88.5), (-1e-3, 1e-3)])
def test_exp_is_xla_cpus(lo, hi):
    x = np.random.default_rng(2).uniform(lo, hi, DRAWS).astype(np.float32)
    _bits_equal(jax.jit(jnp.exp)(x), floats.exp(torch.from_numpy(x)))


def test_bid_noise_is_the_fused_expression():
    """``v * exp(sigma * z)`` as one XLA CPU fusion computes it (the
    executor's and the VI's expression), against the kernel's plain
    version, lanes broadcast as the kernel takes them."""
    rng = np.random.default_rng(3)
    t, c = DRAWS // 64, 16
    v = rng.uniform(0, 1, (t, c)).astype(np.float32)
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (t, c)))
    sigma = np.float32([[0.0] * c, [0.2] * c, list(np.linspace(0, 2, c))])
    fused = jax.jit(lambda v, s, z: v[None] * jnp.exp(s[:, None, :] * z))
    _bits_equal(fused(v, sigma, z), crn_ops.bid_noise(
        torch.from_numpy(v), torch.from_numpy(z), torch.from_numpy(sigma)))
    # sigma = 0 leaves the values as they are
    _bits_equal(v, crn_ops.bid_noise_plain(
        torch.from_numpy(v), torch.from_numpy(z), torch.zeros(1, c))[0])


@pytest.mark.parametrize("stream", sorted(jcrn.STREAMS))
def test_stream_keys(stream):
    _bits_equal(np.asarray(jcrn.stream_key(jax.random.PRNGKey(4), stream))
                .astype(np.int64), crn.stream_key(_key(4), stream))


def test_unknown_stream_text():
    with pytest.raises(ValueError) as want:
        jcrn.stream_key(jax.random.PRNGKey(0), "bogus")
    with pytest.raises(ValueError) as got:
        crn.stream_key(_key(0), "bogus")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("lo,hi", [(0, 512), (128, 384), (511, 512),
                                   (100_000, 100_257)])
@pytest.mark.parametrize("kind", ["normals", "uniforms"])
def test_event_campaign_draws_at_any_slice(lo, hi, kind):
    key = jax.random.PRNGKey(7)
    idx = np.arange(lo, hi, dtype=np.int32)
    want = getattr(jcrn, f"event_campaign_{kind}")(key, jnp.asarray(idx), 8)
    got = getattr(crn, f"event_campaign_{kind}")(
        _key(7), torch.from_numpy(idx), 8)
    _bits_equal(want, got)


def test_cell_keys_and_scattered_indices():
    """The sampled events of Algorithm 4 are not a range."""
    key = jax.random.PRNGKey(2)
    idx = np.random.default_rng(4).permutation(4096)[:300].astype(np.int32)
    _bits_equal(np.asarray(jcrn._cell_keys(key, jnp.asarray(idx), 5))
                .astype(np.int64).view(np.float64).view(np.int32),
                crn._cell_keys(_key(2), torch.from_numpy(idx), 5).numpy()
                .view(np.float64).view(np.int32))
    _bits_equal(jcrn.event_campaign_normals(key, jnp.asarray(idx), 5),
                crn.event_campaign_normals(_key(2), torch.from_numpy(idx),
                                           5))


def test_draws_do_not_depend_on_the_block(monkeypatch):
    idx = torch.arange(1000)
    whole = crn.event_campaign_normals(_key(6), idx, 7)
    monkeypatch.setattr(crn, "BLOCK_CELLS", 7 * 13 + 3)
    out = torch.full((1000, 7), float("nan"))
    blocked = crn.event_campaign_normals(_key(6), idx, 7, out=out)
    assert blocked is out
    _bits_equal(whole.numpy(), blocked)
    _bits_equal(whole[250:500].numpy(),
                crn.event_campaign_normals(_key(6), idx[250:500], 7))
    with pytest.raises(ValueError, match="out must be float32"):
        crn.event_campaign_normals(_key(6), idx, 7, out=torch.empty(3, 7))


@pytest.mark.parametrize("n", [1, 8, 101])
def test_campaign_normals(n):
    key = jax.random.fold_in(jax.random.PRNGKey(1), 3)
    _bits_equal(jcrn.campaign_normals(key, n),
                crn.campaign_normals(key_from_reference(np.asarray(key)), n))


def test_crn_kernel_plain_version():
    """The ``crn_cells`` wrapper's plain version is the draws above."""
    key = crn.stream_key(_key(3), "participation")
    idx = torch.arange(40, 90)
    out = torch.empty((50, 6))
    crn_ops.crn_cells(key, idx, 6, normal=False, out=out)
    _bits_equal(np.asarray(jcrn.event_campaign_uniforms(
        jcrn.stream_key(jax.random.PRNGKey(3), "participation"),
        jnp.arange(40, 90), 6)), out)
