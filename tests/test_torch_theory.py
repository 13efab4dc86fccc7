"""The theory toolbox in the port against ``repro`` on the same inputs:
the bounds, the empirical constants C and gamma (whose probes draw
``jax.random.bernoulli`` and ``randint`` bits, held here bit for bit at
several keys and spans)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import theory as j_theory  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import AuctionRule  # noqa: E402
from repro_torch.core import theory as t_theory  # noqa: E402
from repro_torch.interop import key_from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _partitionable():
    """The port holds the partitionable threefry; compare against it."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", before)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
@pytest.mark.parametrize("lo,hi,shape", [
    (0, 8, ()), (0, 100, (5,)), (3, 4, (7,)), (5, 5, (3,)), (9, 2, (2,)),
    (-3, 2 ** 31 - 1, (7,)), (-2 ** 31, 2 ** 31 - 1, (6,)),
    (0, 65_537, (4, 3)), (-50, 50, (64,))])
def test_randint_is_jax_random(seed, lo, hi, shape):
    want = jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi)
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("p,shape", [(0.8, (24,)), (0.5, (3, 4)),
                                     (0.01, (1000,)), (1.0, (5,)),
                                     (0.0, (5,))])
def test_bernoulli_is_jax_random(seed, p, shape):
    want = jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape)
    got = prng.bernoulli(prng.PRNGKey(seed), p, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_rejects_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 31)


def test_bounds_are_repros():
    assert t_theory.hoeffding_failure_prob(4096, 3.0, 0.01) == \
        j_theory.hoeffding_failure_prob(4096, 3.0, 0.01)
    assert t_theory.thm52_bound(8, 0.2, 0.01, 3.0, 4096, 0.01) == \
        j_theory.thm52_bound(8, 0.2, 0.01, 3.0, 4096, 0.01)
    assert t_theory.cor53_bound(1.5, 0.01, 0.2, 3.0, 4096, 0.01) == \
        j_theory.cor53_bound(1.5, 0.01, 0.2, 3.0, 4096, 0.01)


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_empirical_constants_are_repros(kind):
    env = make_synthetic_env(jax.random.PRNGKey(2), n_events=4096,
                             n_campaigns=16, emb_dim=6)
    m = jnp.linspace(0.8, 1.2, 16, dtype=jnp.float32)
    j_rule = JRule(multipliers=m, reserve=jnp.float32(0.01), kind=kind)
    t_rule = AuctionRule(multipliers=_t(m), reserve=_t(j_rule.reserve),
                         kind=kind)
    values = _t(env.values)
    assert t_theory.estimate_c_const(values, t_rule) == \
        j_theory.estimate_c_const(env.values, j_rule)
    key = jax.random.PRNGKey(7)
    want = j_theory.estimate_gamma(env.values, j_rule, key, num_probes=6)
    got = t_theory.estimate_gamma(values, t_rule,
                                  key_from_reference(np.asarray(key)),
                                  num_probes=6)
    assert got == want
    assert got > 0.0
