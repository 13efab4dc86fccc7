"""Algorithm 2 for one design: the port's ``parallel_simulate`` (device and
host drivers, every resolve back-end) against ``repro``'s on the same
inputs — final spends, cap times, the segment history and the trace, bit
for bit — and the error contracts of the entry points this slice adds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import parallel_simulate as j_parallel  # noqa: E402
from repro.core import segments as j_segments  # noqa: E402
from repro.core.executor import _unknown as j_unknown  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              ParallelSimTrace, Segments, SweepPlan,
                              parallel_simulate, parallel_state_machine,
                              sweep_state_machine)
from repro_torch.core import segments as t_segments  # noqa: E402
from repro_torch.core.executor import RESOLVE_BACKENDS, _unknown  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS, N_CAMPAIGNS = 4096, 16


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(1), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


def _designs(env):
    """(name, repro rule, budgets) for both pricing rules, one with a
    reserve and tighter budgets."""
    m = jnp.full((N_CAMPAIGNS,), 1.1, jnp.float32)
    return {
        "first": (JRule.first_price(N_CAMPAIGNS), env.budgets),
        "second_reserve": (JRule(multipliers=m, reserve=jnp.float32(0.05),
                                 kind="second_price"), env.budgets * 0.6),
    }


def _port(env, rule, budgets):
    t = lambda x: torch.from_numpy(np.array(x, copy=True))
    return (t(env.values), t(budgets),
            AuctionRule(multipliers=t(rule.multipliers),
                        reserve=t(rule.reserve), kind=rule.kind))


@pytest.fixture(scope="module")
def reference(env):
    """``repro``'s device-driver result and trace for each design."""
    return {name: j_parallel(env.values, b, rule, driver="device",
                             resolve="jnp", return_trace=True)
            for name, (rule, b) in _designs(env).items()}


def _assert_same(want, want_trace, got, got_trace):
    np.testing.assert_array_equal(np.asarray(want.final_spend),
                                  got.final_spend.numpy())
    np.testing.assert_array_equal(np.asarray(want.cap_times),
                                  got.cap_times.numpy())
    assert got.cap_times.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want.segments.boundaries),
                                  got.segments.boundaries.numpy())
    np.testing.assert_array_equal(np.asarray(want.segments.masks),
                                  got.segments.masks.numpy())
    assert got_trace.capped_order == [int(c) for c in
                                      want_trace.capped_order]
    assert got_trace.boundaries == [int(b) for b in want_trace.boundaries]
    assert got_trace.num_rounds == want_trace.num_rounds


@pytest.mark.parametrize("resolve", ["torch", "sweep_resolve", "fused",
                                     "auto"])
@pytest.mark.parametrize("design", ["first", "second_reserve"])
def test_device_driver_bitwise_the_reference(env, reference, design,
                                             resolve):
    rule, budgets = _designs(env)[design]
    values, t_budgets, t_rule = _port(env, rule, budgets)
    got, trace = parallel_simulate(values, t_budgets, t_rule,
                                   driver="device", resolve=resolve,
                                   return_trace=True)
    _assert_same(*reference[design], got, trace)


@pytest.mark.parametrize("design", ["first", "second_reserve"])
def test_host_driver_bitwise_the_reference(env, reference, design):
    """The host loop (numpy bookkeeping over ``masked_rate`` /
    ``block_spend_sums``) against ``repro``'s host loop and its device
    driver: the same bits."""
    rule, budgets = _designs(env)[design]
    want, want_trace = j_parallel(env.values, budgets, rule, driver="host",
                                  return_trace=True)
    values, t_budgets, t_rule = _port(env, rule, budgets)
    got, trace = parallel_simulate(values, t_budgets, t_rule, driver="host",
                                   return_trace=True)
    _assert_same(want, want_trace, got, trace)
    _assert_same(*reference[design], got, trace)


def test_custom_closures_select_the_host_driver(env, reference):
    rule, budgets = _designs(env)["first"]
    values, t_budgets, t_rule = _port(env, rule, budgets)
    calls = []

    def rate_fn(active, lo):
        calls.append(int(lo))
        return t_segments.masked_rate(values, active, t_rule, lo)

    got, trace = parallel_simulate(values, t_budgets, t_rule,
                                   rate_fn=rate_fn, return_trace=True)
    assert len(calls) == trace.num_rounds
    _assert_same(*reference["first"], got, trace)
    with pytest.raises(ValueError, match="need driver='host'"):
        parallel_simulate(values, t_budgets, t_rule, rate_fn=rate_fn,
                          driver="device")


def test_masked_rate_and_block_spend_sums_bitwise_the_reference(env):
    rule, budgets = _designs(env)["second_reserve"]
    values, _, t_rule = _port(env, rule, budgets)
    active = np.arange(N_CAMPAIGNS) % 5 != 2
    want = j_segments.masked_rate(env.values, jnp.asarray(active), rule,
                                  jnp.int32(1000))
    got = t_segments.masked_rate(values, torch.from_numpy(active), t_rule,
                                 torch.tensor(1000))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    want = j_segments.block_spend_sums(env.values, jnp.asarray(active), rule,
                                       jnp.int32(700), jnp.int32(3001))
    got = t_segments.block_spend_sums(values, torch.from_numpy(active),
                                      t_rule, torch.tensor(700),
                                      torch.tensor(3001))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_state_machine_and_engine_simulate(env, reference):
    rule, budgets = _designs(env)["first"]
    values, t_budgets, t_rule = _port(env, rule, budgets)
    s_hat, cap, retired, bnds, rounds, n_hat = parallel_state_machine(
        values, t_budgets, t_rule, resolve="sweep_resolve")
    batched = sweep_state_machine(
        values, t_budgets[None], AuctionRule(
            multipliers=t_rule.multipliers[None],
            reserve=t_rule.reserve.reshape(1), kind=t_rule.kind))
    for a, b in zip((s_hat, cap, retired, bnds, rounds, n_hat), batched):
        assert torch.equal(a, b[0])
    engine = CounterfactualEngine(values, t_budgets, base_rule=t_rule,
                                  device="cpu")
    got, trace = engine.simulate(method="parallel", return_trace=True)
    _assert_same(*reference["first"], got, trace)
    assert isinstance(trace, ParallelSimTrace)
    assert isinstance(got.segments, Segments)
    seg = got.segments
    ids = seg.seg_ids(N_EVENTS)
    assert ids.dtype == torch.int32 and int(ids[0]) == 0
    assert int(ids[-1]) == seg.num_segments - 1
    want_ids = reference["first"][0].segments.seg_ids(N_EVENTS)
    np.testing.assert_array_equal(np.asarray(want_ids), ids.numpy())
    trivial = Segments.trivial(N_EVENTS, N_CAMPAIGNS, device="cpu")
    assert trivial.num_segments == 1
    assert trivial.boundaries.tolist() == [0, N_EVENTS]


def test_pallas_is_refused_with_the_unknown_option_text(env):
    """``repro``'s ``"pallas"`` back-end is the port's ``"sweep_resolve"``:
    the name is refused with the reference's unknown-option message."""
    text = str(j_unknown("resolve back-end", "pallas",
                         RESOLVE_BACKENDS + ("auto",)))
    assert str(_unknown("resolve back-end", "pallas",
                        RESOLVE_BACKENDS + ("auto",))) == text
    assert "'sweep_resolve'" in text
    rule, budgets = _designs(env)["first"]
    values, t_budgets, t_rule = _port(env, rule, budgets)
    with pytest.raises(ValueError) as err:
        SweepPlan(resolve="pallas")
    assert str(err.value) == text
    with pytest.raises(ValueError) as err:
        parallel_simulate(values, t_budgets, t_rule, resolve="pallas")
    assert str(err.value) == text
    engine = CounterfactualEngine(values, t_budgets, device="cpu")
    with pytest.raises(ValueError) as err:
        engine.sweep(engine.grid(bid_scales=[1.0]), resolve="pallas")
    assert str(err.value) == text


def test_record_events_and_unknown_driver_raise(env):
    """``record_events`` replays the segment history (``aggregate``) for
    repro's per-event winners and prices; an unknown driver raises."""
    rule, budgets = _designs(env)["first"]
    values, t_budgets, t_rule = _port(env, rule, budgets)
    want = j_parallel(env.values, budgets, rule, record_events=True)
    for driver in ("device", "host"):
        got = parallel_simulate(values, t_budgets, t_rule, driver=driver,
                                record_events=True)
        np.testing.assert_array_equal(got.winners.numpy(),
                                      np.asarray(want.winners))
        np.testing.assert_array_equal(got.prices.numpy(),
                                      np.asarray(want.prices))
        np.testing.assert_array_equal(got.final_spend.numpy(),
                                      np.asarray(want.final_spend))
    with pytest.raises(ValueError) as err:
        parallel_simulate(values, t_budgets, t_rule, driver="sharded")
    assert str(err.value) == str(j_unknown("driver", "sharded",
                                           ("auto", "device", "host")))
