"""The port's counter-based random numbers against ``jax.random``, bit for
bit: keys, splits, fold-ins, 32-bit words, uniforms and permutations (the
draws of Algorithms 3-4), with ``jax_threefry_partitionable`` set
explicitly so a jax that defaults otherwise compares like for like."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.interop import key_from_reference  # noqa: E402


@pytest.fixture(autouse=True)
def _partitionable():
    """The port holds the partitionable threefry; compare against it."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", before)


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, -1, 2 ** 31 - 1])
def test_prng_key(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


def test_prng_key_rejects_seeds_outside_32_bits():
    with pytest.raises(ValueError, match="32-bit"):
        prng.PRNGKey(2 ** 31)


@pytest.mark.parametrize("num", [2, 3, 3140])
def test_split(num):
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(7), num).numpy(),
                                  _words(jax.random.split(key, num)))


@pytest.mark.parametrize("data", [0, 1, 12345, 2 ** 32 - 1])
def test_fold_in(data):
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        prng.fold_in(prng.PRNGKey(3), data).numpy(),
        _words(jax.random.fold_in(key, data)))


@pytest.mark.parametrize("shape", [(), (5,), (5, 7), (64, 1)])
def test_random_bits(shape):
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    got = prng.random_bits(key_from_reference(np.asarray(key)), shape)
    np.testing.assert_array_equal(got.numpy(),
                                  _words(jax.random.bits(key, shape)))


def test_uniform_one_key_and_a_batch_of_keys():
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(5), (64, 3)).numpy(),
        np.asarray(jax.random.uniform(key, (64, 3))))
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(5), (4,), minval=-2.0, maxval=3.0).numpy(),
        np.asarray(jax.random.uniform(key, (4,), minval=-2.0, maxval=3.0)))
    keys = jax.random.split(key, 10)
    want = np.stack([np.asarray(jax.random.uniform(k, (64, 1)))
                     for k in keys])
    got = prng.uniform(prng.split(prng.PRNGKey(5), 10), (64, 1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [64, 8192, 100_000])
def test_permutation_and_choice_without_replacement(n):
    key = jax.random.PRNGKey(n)
    np.testing.assert_array_equal(
        prng.permutation(prng.PRNGKey(n), n).numpy(),
        np.asarray(jax.random.permutation(key, n)))
    k = max(n // 100, 64)
    np.testing.assert_array_equal(
        prng.choice(prng.PRNGKey(n), n, k).numpy(),
        np.asarray(jax.random.choice(key, n, (k,), replace=False)))


def test_key_from_reference_checks_the_shape():
    with pytest.raises(ValueError, match="two uint32 words"):
        key_from_reference(np.zeros(3, np.uint32))
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(prng.PRNGKey(0), 4, 5)
