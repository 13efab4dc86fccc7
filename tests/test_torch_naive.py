"""The naive sampled replay (the paper's Fig.-1 baseline) in the port
against ``repro`` on the same inputs (``repro.data.make_synthetic_env``),
bit for bit at the same key: spends, cap times and the mapping of a
sampled cap time back to the log; and the engine's ``method=
"naive_sampling"`` (``simulate`` runs it, ``sweep`` refuses it as
``repro`` does)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core.sequential import \
    naive_sampled_replay as j_naive  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              naive_sampled_replay)
from repro_torch.core.sequential import (inverse_rate,  # noqa: E402
                                         sampled_cap_times)
from repro_torch.interop import key_from_reference  # noqa: E402
from repro_torch.kernels.capped_scan.ref import \
    capped_scan_windows_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS, N_CAMPAIGNS = 8192, 12


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(4), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=6)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def _rules(kind):
    m = jnp.linspace(0.9, 1.3, N_CAMPAIGNS, dtype=jnp.float32)
    j_rule = JRule(multipliers=m, reserve=jnp.float32(0.03), kind=kind)
    t_rule = AuctionRule(multipliers=_t(m), reserve=_t(j_rule.reserve),
                         kind=kind)
    return j_rule, t_rule


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
@pytest.mark.parametrize("seed,sample_size,budget_scale", [
    (0, 82, 1.0), (3, 410, 0.5), (11, 1000, 0.2), (5, 8192, 0.3)])
def test_naive_sampled_replay_is_repros(env, kind, seed, sample_size,
                                        budget_scale):
    """At rho = 1%, 5%, 12.2% and 100%, budgets tight enough that most
    campaigns cap in the sample: spends and cap times bit for bit."""
    j_rule, t_rule = _rules(kind)
    budgets = env.budgets * jnp.float32(budget_scale)
    key = jax.random.PRNGKey(seed)
    want = j_naive(env.values, budgets, j_rule, key, sample_size)
    got = naive_sampled_replay(_t(env.values), _t(budgets), t_rule,
                               key_from_reference(np.asarray(key)),
                               sample_size)
    _same(want.final_spend, got.final_spend)
    _same(want.cap_times, got.cap_times)
    assert got.winners is None and got.prices is None
    if budget_scale < 1.0:
        assert int((got.cap_times <= N_EVENTS).sum()) > 0


def test_the_kernels_split_is_the_sampled_replay(env):
    """What the card runs, by the kernel's split (windows against a frozen
    active set, each sale times 1/rho; ``capped_scan_windows_ref``), the
    cap times mapped afterwards: the sampled replay's bits."""
    _, t_rule = _rules("second_price")
    budgets = _t(env.budgets * jnp.float32(0.3))
    sample_size = 300
    key = prng.PRNGKey(2)
    idx = torch.sort(prng.choice(key, N_EVENTS, sample_size)).values
    _, _, spend, cap_sub = capped_scan_windows_ref(
        _t(env.values)[idx], budgets[None], t_rule.multipliers[None],
        t_rule.reserve.reshape(1), second_price=True, window=64,
        scale=float(inverse_rate(sample_size, N_EVENTS)))
    want = naive_sampled_replay(_t(env.values), budgets, t_rule, key,
                                sample_size)
    _same(want.final_spend, spend[0])
    _same(want.cap_times, sampled_cap_times(cap_sub[0], sample_size,
                                            N_EVENTS))
    assert int((cap_sub <= sample_size).sum()) > 0


@pytest.mark.parametrize("sample_size", [10, 82, 4096, 8192])
def test_sampled_cap_times_map_as_repro_does(sample_size):
    """Every sampled cap time 1..K and the never-capped K+1, mapped as
    ``repro``'s compiled step maps them: ``((n_sub + 1) / rho)`` with rho
    a constant of the program, cast to int32."""
    rho = sample_size / N_EVENTS
    sub = np.arange(1, sample_size + 2, dtype=np.int32)
    step = jax.jit(lambda n: (n / rho).astype(jnp.int32))
    want = np.asarray(step(jnp.asarray(sub[:-1])))
    got = sampled_cap_times(torch.from_numpy(sub), sample_size, N_EVENTS)
    _same(want, got[:-1])
    assert int(got[-1]) == N_EVENTS + 1


def test_engine_naive_sampling(env):
    """``simulate`` and ``compare`` run it (the key split as ``repro``
    splits it); ``sweep`` refuses it with ``repro``'s error."""
    j_engine = JEngine(env.values, env.budgets * jnp.float32(0.5))
    t_engine = CounterfactualEngine(_t(env.values),
                                    _t(env.budgets * jnp.float32(0.5)),
                                    device="cpu")
    want = j_engine.simulate(method="naive_sampling", sample_size=500)
    got = t_engine.simulate(method="naive_sampling", sample_size=500)
    _same(want.final_spend, got.final_spend)
    _same(want.cap_times, got.cap_times)
    j_alt = JRule.first_price(N_CAMPAIGNS).with_multiplier(0, 1.5)
    t_alt = AuctionRule.first_price(N_CAMPAIGNS, device="cpu") \
        .with_multiplier(0, 1.5)
    want = j_engine.compare(j_alt, method="naive_sampling", sample_size=300)
    got = t_engine.compare(t_alt, method="naive_sampling", sample_size=300)
    _same(want.spend_base, got.spend_base)
    _same(want.spend_alt, got.spend_alt)
    _same(want.cap_times_alt, got.cap_times_alt)
    # revenue sums the (C,) spends; the two libraries' sums associate
    # differently
    assert got.revenue_alt == pytest.approx(want.revenue_alt, rel=1e-6)
    grid_j = j_engine.grid(bid_scales=[1.0])
    grid_t = t_engine.grid(bid_scales=[1.0])
    with pytest.raises(ValueError) as j_err:
        j_engine.sweep(grid_j, method="naive_sampling")
    with pytest.raises(ValueError) as t_err:
        t_engine.sweep(grid_t, method="naive_sampling")
    assert str(t_err.value) == str(j_err.value) \
        == "unknown sweep method: naive_sampling"
