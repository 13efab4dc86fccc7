"""SORT2AGGREGATE and Algorithm 4 in the port against ``repro`` on the same
inputs, bit for bit: segment histories, the XLA-order first-crossing scan
(including budgets placed within one ulp of the running spend), the
aggregate pass, both refinements, the VI estimate, the estimator and the
engine's ``simulate``/``compare``/``sweep(method="sort2aggregate")`` in
every warm-start mode, and the sweep's error texts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import Segments as JSegments  # noqa: E402
from repro.core import metrics as j_metrics  # noqa: E402
from repro.core import segments as j_seg  # noqa: E402
from repro.core import sequential_replay as j_sequential  # noqa: E402
from repro.core.sort2aggregate import (  # noqa: E402
    refine_fixed_device as j_refine_fixed_device,
    refine_segments as j_refine_segments, sort2aggregate as j_sort2aggregate)
from repro.core import sweep_sort2aggregate as j_sweep_s2a  # noqa: E402
from repro.core import vi as j_vi  # noqa: E402
from repro.core.executor import ChunkSpec  # noqa: E402
from repro.core.executor import SweepPlan as JPlan  # noqa: E402
from repro.core.executor import check_s2a_options as j_check  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              Segments, SweepPlan, check_s2a_options,
                              metrics, refine_fixed_device, refine_segments,
                              segments, sort2aggregate, sweep_sort2aggregate,
                              vi)
from repro_torch.interop import from_reference, key_from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS, N_CAMPAIGNS = 4096, 16
KINDS = ("first_price", "second_price")


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(1), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _design(kind):
    """A design with a reserve and raised bids, so both rules sell and cap
    at different times."""
    m = jnp.linspace(0.9, 1.2, N_CAMPAIGNS, dtype=jnp.float32)
    return JRule(multipliers=m, reserve=jnp.float32(0.02), kind=kind)


def _port_rule(rule):
    return AuctionRule(multipliers=_t(rule.multipliers),
                       reserve=_t(rule.reserve), kind=rule.kind)


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def _same_result(want, got, events=False):
    _same(want.final_spend, got.final_spend)
    _same(want.cap_times, got.cap_times)
    assert got.cap_times.dtype == torch.int32
    if events:
        _same(want.winners, got.winners)
        _same(want.prices, got.prices)


# ---------------------------------------------------------------------------
# Segment histories and the first-crossing scan
# ---------------------------------------------------------------------------

def test_segments_from_cap_times_ties_and_never_capped():
    n = 100
    caps = np.array([50, 101, 7, 50, 200, 100, 1, 7], np.int32)
    want = JSegments.from_cap_times(jnp.asarray(caps), n)
    got = Segments.from_cap_times(_t(caps), n)
    _same(want.boundaries, got.boundaries)
    _same(want.masks, got.masks)
    assert got.boundaries.dtype == torch.int32
    _same(want.seg_ids(n), got.seg_ids(n))
    batched = Segments.from_cap_times(_t(np.stack([caps, caps[::-1]])), n)
    rev = JSegments.from_cap_times(jnp.asarray(caps[::-1].copy()), n)
    _same(rev.boundaries, batched.boundaries[1])
    _same(rev.masks, batched.masks[1])


@pytest.mark.parametrize("n", [5, 16, 17, 100, 1000, 4096, 4100])
def test_xla_cumsum_is_jnp_cumsum(n):
    rng = np.random.default_rng(n)
    x = (rng.random((n, 7)) * (rng.random((n, 7)) < 0.3)).astype(np.float32)
    _same(jnp.cumsum(jnp.asarray(x), axis=0), segments.xla_cumsum(_t(x)))


def _blockwise_running_spend(w, p, c, block):
    """repro's running spend of every (event, campaign), the value each
    crossing test compares with the budget: every block's ``jnp.cumsum``
    at once, then ``s0 + cumsum`` block by block in float32."""
    n = len(w)
    pad = (-n) % block
    sm = (np.pad(w, (0, pad), constant_values=-1)[:, None] == np.arange(c)) \
        * np.pad(p, (0, pad))[:, None]
    blocks = np.asarray(jnp.cumsum(
        jnp.asarray(sm.astype(np.float32)).reshape(-1, block, c), axis=1))
    s0 = np.zeros(c, np.float32)
    out = []
    for cs in blocks:
        cum = s0[None, :] + cs
        out.append(cum)
        s0 = cum[-1]
    return np.concatenate(out)[:n]


@pytest.mark.parametrize("block", [4096, 1000, 256, 17])
def test_first_crossing_times_within_an_ulp(block):
    """Budgets equal to repro's own running spend at random events (many of
    them across block boundaries), and one ulp above it: every cap time
    moves with the ulp, and the port follows it."""
    n, c = 8192, 12
    rng = np.random.default_rng(block)
    w = rng.integers(-1, c, n).astype(np.int32)
    p = np.where(w >= 0, rng.random(n), 0.0).astype(np.float32)
    cum = _blockwise_running_spend(w, p, c, block)
    rows = rng.integers(0, n, c)
    rows[:4] = [block - 1, block, min(2 * block, n - 1), n - 1]
    budgets = cum[rows, np.arange(c)]
    for b in (budgets, np.nextafter(budgets, np.float32(np.inf))):
        want = j_seg.first_crossing_times(jnp.asarray(w), jnp.asarray(p),
                                          jnp.asarray(b), c, block=block)
        got = segments.first_crossing_times(_t(w), _t(p), _t(b), c, block)
        _same(want, got)
        lanes = segments.first_crossing_times(
            _t(np.stack([w, w])), _t(np.stack([p, p])),
            _t(np.stack([b, b])), c, block)
        _same(np.stack([want, want]), lanes)


@pytest.fixture(scope="module")
def oracle(env):
    """The exact replay of each rule's design (cap times to aggregate at)."""
    return {kind: j_sequential(env.values, env.budgets, _design(kind))
            for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_aggregate_at_the_oracle_cap_times(env, oracle, kind):
    rule = _design(kind)
    caps = oracle[kind].cap_times
    want = j_seg.aggregate(env.values, JSegments.from_cap_times(
        caps, N_EVENTS), env.budgets, rule)
    got = segments.aggregate(_t(env.values), Segments.from_cap_times(
        _t(caps), N_EVENTS), _t(env.budgets), _port_rule(rule))
    _same_result(want, got, events=True)
    wider = j_seg.aggregate(env.values, JSegments.from_cap_times(
        caps, N_EVENTS), env.budgets, rule, record_events=False,
        crossing_block=1000)
    got = segments.aggregate(_t(env.values), Segments.from_cap_times(
        _t(caps), N_EVENTS), _t(env.budgets), _port_rule(rule),
        record_events=False, crossing_block=1000)
    _same_result(wider, got)
    assert got.winners is None


# ---------------------------------------------------------------------------
# Refinement, Algorithm 4, the estimator
# ---------------------------------------------------------------------------

def _all_active():
    return np.full(N_CAMPAIGNS, N_EVENTS + 1, np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_refine_segments(env, kind):
    rule = _design(kind)
    want = j_refine_segments(env.values, env.budgets, rule,
                                 jnp.asarray(_all_active()), max_iters=6)
    got = refine_segments(
        _t(env.values), _t(env.budgets), _port_rule(rule),
        _t(_all_active()), max_iters=6)
    _same(want[0], got[0])
    assert (want[1], want[2]) == (got[1], got[2])


@pytest.mark.parametrize("kind", KINDS)
def test_refine_fixed_device(env, kind):
    rule = _design(kind)
    want, want_gap, want_iters = j_refine_fixed_device(
        env.values, env.budgets, rule, jnp.asarray(_all_active()),
        refine_iters=4, record_events=True)
    got, gap, iters = refine_fixed_device(
        _t(env.values), _t(env.budgets), _port_rule(rule),
        _t(_all_active()), refine_iters=4, record_events=True)
    _same_result(want, got, events=True)
    _same(want_gap, gap)
    _same(want_iters, iters)
    _same(want.segments.boundaries, got.segments.boundaries)


@pytest.mark.parametrize("batch_size,coupling", [
    (1, "shared"), (64, "shared"), (64, "independent")])
@pytest.mark.parametrize("kind", KINDS)
def test_estimate_pi(env, kind, batch_size, coupling):
    rule = _design(kind)
    key = jax.random.PRNGKey(3)
    kw = dict(sample_size=200, num_iters=4 if batch_size == 1 else 30,
              batch_size=batch_size, coupling=coupling, track_every=3,
              eta_decay=0.05)
    want = j_vi.estimate_pi(env.values, env.budgets, rule, key, **kw)
    got = vi.estimate_pi(_t(env.values), _t(env.budgets), _port_rule(rule),
                         key_from_reference(np.asarray(key)), **kw)
    _same(want.pi, got.pi)
    _same(want.history, got.history)
    _same(want.num_updates, got.num_updates)
    _same(j_vi.pi_to_cap_times(want.pi, N_EVENTS),
          vi.pi_to_cap_times(got.pi, N_EVENTS))
    for a, b in zip(j_vi.capping_order(want.pi), vi.capping_order(got.pi)):
        _same(a, b)


def test_estimate_pi_sweep(env):
    grid = JGrid.product(_design("first_price"), env.budgets,
                         bid_scales=[1.0, 1.3], budget_scales=[1.0, 0.5])
    key = jax.random.PRNGKey(4)
    pi0 = jnp.full((4, N_CAMPAIGNS), 0.9, jnp.float32)
    kw = dict(sample_size=256, num_iters=10, batch_size=64, eta_decay=0.05)
    want = j_vi.estimate_pi_sweep(env.values, grid.budgets, grid.rules, key,
                                  pi0=pi0, **kw)
    values, t_grid = from_reference(env.values, grid.budgets,
                                    grid.rules.multipliers,
                                    grid.rules.reserve, grid.rules.kind,
                                    device="cpu")
    got = vi.estimate_pi_sweep(values, t_grid.budgets, t_grid.rules,
                               key_from_reference(np.asarray(key)),
                               pi0=_t(pi0), **kw)
    _same(want.pi, got.pi)
    _same(want.num_updates, got.num_updates)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_sort2aggregate(env, oracle, kind, warm):
    rule = _design(kind)
    key = jax.random.PRNGKey(5)
    init = oracle[kind].cap_times + 40 if warm else None
    want = j_sort2aggregate(env.values, env.budgets, rule, key,
                                cap_times_init=init, refine_iters=5,
                                record_events=True)
    got = sort2aggregate(
        _t(env.values), _t(env.budgets), _port_rule(rule),
        key_from_reference(np.asarray(key)),
        cap_times_init=None if init is None else _t(init), refine_iters=5,
        record_events=True)
    _same_result(want.result, got.result, events=True)
    assert (got.refine_iters_used, got.converged, got.consistency_gap) == \
        (want.refine_iters_used, want.converged, want.consistency_gap)
    if warm:
        assert got.pi is None
    else:
        _same(want.pi, got.pi)


def test_metrics(env, oracle):
    want = j_sort2aggregate(env.values, env.budgets, _design(
        "first_price"), jax.random.PRNGKey(0)).result
    ref = oracle["first_price"]
    s_hat, s_ref = _t(want.final_spend), _t(ref.final_spend)
    _same(j_metrics.relative_error(want.final_spend, ref.final_spend),
          metrics.relative_error(s_hat, s_ref))
    _same(j_metrics.spend_weighted_relative_error(want.final_spend,
                                                  ref.final_spend),
          metrics.spend_weighted_relative_error(s_hat, s_ref))
    for a, b in zip(j_metrics.relative_error_cdf(want.final_spend,
                                                 ref.final_spend),
                    metrics.relative_error_cdf(s_hat, s_ref)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.cap_time_error(_t(want.cap_times), _t(ref.cap_times),
                               N_EVENTS).numpy(),
        np.asarray(j_metrics.cap_time_error(want.cap_times, ref.cap_times,
                                            N_EVENTS)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _engines(env, kind):
    rule = _design(kind)
    j_engine = JEngine(env.values, env.budgets, base_rule=rule)
    t_engine = CounterfactualEngine(_t(env.values), _t(env.budgets),
                                    base_rule=_port_rule(rule),
                                    device="cpu")
    return j_engine, t_engine


@pytest.mark.parametrize("kind", KINDS)
def test_engine_simulate_default_and_compare(env, kind):
    j_engine, t_engine = _engines(env, kind)
    _same_result(j_engine.simulate(), t_engine.simulate())
    alt = _design(kind)
    alt = JRule(multipliers=alt.multipliers * 1.2, reserve=jnp.float32(0.0),
                kind=kind)
    want = j_engine.compare(alt, env.budgets * 0.8)
    got = t_engine.compare(_port_rule(alt), _t(env.budgets * 0.8))
    for name in ("spend_base", "spend_alt", "cap_times_base",
                 "cap_times_alt"):
        _same(getattr(want, name), getattr(got, name))
    assert (got.revenue_base, got.revenue_alt) == pytest.approx(
        (want.revenue_base, want.revenue_alt), rel=1e-6)
    np.testing.assert_allclose(got.revenue_lift, want.revenue_lift,
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("warm_start", ["base", "per_scenario", False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_engine_sweep_sort2aggregate(env, kind, warm_start):
    j_engine, t_engine = _engines(env, kind)
    axes = dict(bid_scales=[1.0, 1.3], reserves=[0.0, 0.05],
                budget_scales=[1.0, 0.5])
    j_grid = j_engine.grid(**axes)
    _, t_grid = from_reference(env.values, j_grid.budgets,
                               j_grid.rules.multipliers,
                               j_grid.rules.reserve, kind, j_grid.labels,
                               device="cpu")
    kw = dict(method="sort2aggregate", warm_start=warm_start,
              refine_iters=4)
    want = j_engine.sweep(j_grid, **kw)
    got = t_engine.sweep(t_grid, **kw)
    _same_result(want.results, got.results)
    _same(want.consistency_gaps, got.consistency_gaps)
    _same(want.refine_iters, got.refine_iters)
    for t_row, j_row in zip(got.delta_table(), want.delta_table()):
        # revenue is the float32 sum of final_spend over campaigns, which
        # torch and XLA add in different orders (ROADMAP.md §4)
        np.testing.assert_allclose(t_row.pop("revenue"), j_row.pop("revenue"),
                                   rtol=1e-6)
        np.testing.assert_allclose(t_row.pop("revenue_lift"),
                                   j_row.pop("revenue_lift"), rtol=1e-6,
                                   atol=1e-6)
        assert t_row == j_row


def test_sweep_sort2aggregate_records_events_and_takes_a_block(env):
    grid = JGrid.product(_design("second_price"), env.budgets,
                         bid_scales=[1.0, 1.2])
    values, t_grid = from_reference(env.values, grid.budgets,
                                    grid.rules.multipliers,
                                    grid.rules.reserve, grid.rules.kind,
                                    device="cpu")
    want = j_sweep_s2a(env.values, grid.budgets, grid.rules,
                       refine_iters=3, record_events=True,
                       crossing_block=1000)
    got = sweep_sort2aggregate(values, t_grid.budgets, t_grid.rules,
                               refine_iters=3, record_events=True,
                               crossing_block=1000)
    _same_result(want[0], got[0], events=True)
    _same(want[1], got[1])
    _same(want[2], got[2])


# ---------------------------------------------------------------------------
# Options and errors
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


def test_check_s2a_options_error_texts():
    check_s2a_options(SweepPlan(), record_events=True)
    check_s2a_options(SweepPlan(placement="device"))
    chunks = ChunkSpec(events_per_chunk=1024)
    assert _message(lambda: check_s2a_options(
        SweepPlan(), True, chunks=1024)) == _message(
        lambda: j_check(JPlan(chunks=chunks), True))
    assert _message(lambda: check_s2a_options(
        SweepPlan(), scenario_chunks=2)) == _message(
        lambda: j_check(JPlan(scenario_chunks=2)))
    with pytest.raises(NotImplementedError, match="queue 1, item 3"):
        check_s2a_options(SweepPlan(), chunks=1024)


def test_engine_sweep_rejects_what_repro_rejects(env):
    j_engine, t_engine = _engines(env, "first_price")
    grid = t_engine.grid(bid_scales=[1.0])
    j_grid = j_engine.grid(bid_scales=[1.0])
    for kw in (dict(warm_start="later"),
               dict(method="sort2aggregate", scenario_chunks=2),
               dict(method="sequential", chunks=1024),
               dict(method="sort2aggregate", record_events=True,
                    chunks=1024)):
        assert _message(lambda: t_engine.sweep(grid, **kw)) == \
            _message(lambda: j_engine.sweep(j_grid, **kw))
    with pytest.raises(NotImplementedError, match="naive_sampled_replay"):
        t_engine.simulate(method="naive_sampling")
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        vi.estimate_pi(_t(env.values), _t(env.budgets),
                       _port_rule(_design("first_price")),
                       key_from_reference(np.asarray(jax.random.PRNGKey(0))),
                       sample_size=64, overlay_row=object())
