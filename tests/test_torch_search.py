"""Scenario-space search in the port: ``tests/test_search.py``'s
closed-form goldens (a log whose revenue-maximising reserve is 1/2) and
contracts, run on the port's engine on the CPU, and the same trajectory,
ledger and best point as ``repro``'s search on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.search import CapRateCeiling as JCapRate  # noqa: E402
from repro.search import SearchSpace as JSpace  # noqa: E402
from repro_torch.core import (AuctionRule, ChunkSpec,  # noqa: E402
                              CounterfactualEngine)
from repro_torch.search import (BudgetExhausted, CapRateCeiling,  # noqa: E402
                                EvaluationLedger, SEARCH_METHODS,
                                SearchSpace, as_objective,
                                coordinate_hillclimb, revenue_objective,
                                score_sweep, successive_halving)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_GOLDEN_N, _GOLDEN_C = 512, 2
_R_STAR = 0.5
_R_TOL = 0.05


def _golden_arrays():
    values = np.zeros((_GOLDEN_N, _GOLDEN_C), np.float32)
    values[:, 0] = np.linspace(1.0 / _GOLDEN_N, 1.0, _GOLDEN_N)
    return values, np.full((_GOLDEN_C,), 1e9, np.float32)


@pytest.fixture(scope="module")
def golden_engine():
    """Second price, campaign 0 bidding ``linspace(1/N, 1)`` and campaign
    1 never: every sale pays the reserve, so revenue(r) = r · #{v > r},
    maximised at r* = 1/2."""
    values, budgets = _golden_arrays()
    return CounterfactualEngine(
        torch.from_numpy(values), torch.from_numpy(budgets),
        base_rule=AuctionRule.second_price(_GOLDEN_C, device="cpu"),
        device="cpu")


def test_space_ledger_and_scores(golden_engine):
    with pytest.raises(ValueError, match="at least one bounded axis"):
        SearchSpace()
    s2 = SearchSpace(reserve=(0.0, 1.0), budget_scale=(0.5, 2.0))
    assert len(s2.grid(16)) == 16 and len(s2.grid(15)) == 9
    led = EvaluationLedger(budget=10)
    led.charge(4, "a")
    led.charge(6, "b")
    with pytest.raises(BudgetExhausted, match="evaluation budget exhausted"):
        led.charge(1, "c")
    assert led.spent == 10
    swept = golden_engine.sweep(golden_engine.grid(reserves=[0.1, 0.5]))
    values, margins = score_sweep(swept, revenue_objective, ())
    assert values.shape == margins.shape == (2,) and (margins == 0).all()
    _, m = score_sweep(swept, as_objective("revenue"),
                       (CapRateCeiling(0.1),))
    np.testing.assert_allclose(m, 0.1)
    with pytest.raises(ValueError, match="unknown objective"):
        as_objective("profit")


def test_grid_from_points_is_repros():
    """Points to a grid, ``boost[c]`` a float32 multiply of campaign c's
    multiplier on top of ``bid_scale``: bit for bit ``repro``'s grid."""
    values, budgets = _golden_arrays()
    base = np.array([1.0, 0.7], np.float32)
    j_engine = JEngine(jnp.asarray(values), jnp.asarray(budgets),
                       JRule(multipliers=jnp.asarray(base),
                             reserve=jnp.float32(0.1), kind="first_price"))
    t_engine = CounterfactualEngine(
        torch.from_numpy(values), torch.from_numpy(budgets),
        AuctionRule(multipliers=torch.from_numpy(base),
                    reserve=torch.tensor(0.1), kind="first_price"),
        device="cpu")
    points = [{}, {"bid_scale": 1.1}, {"bid_scale": 2.0, "boost[0]": 3.3},
              {"reserve": 0.37, "budget_scale": 0.3, "boost[1]": 0.77}]
    want = j_engine.grid_from_points(points)
    got = t_engine.grid_from_points(points)
    assert got.labels == want.labels
    for a, b in ((want.rules.multipliers, got.rules.multipliers),
                 (want.rules.reserve, got.rules.reserve),
                 (want.budgets, got.budgets)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="unknown grid axis"):
        t_engine.grid_from_points([{"boost": 2.0}])


@pytest.mark.parametrize("method", SEARCH_METHODS)
def test_search_finds_known_optimal_reserve(golden_engine, method):
    space = SearchSpace(reserve=(0.0, 1.0))
    res = golden_engine.search(space, method=method, budget=64)
    assert res.converged and res.best_feasible
    assert abs(res.best_point["reserve"] - _R_STAR) < _R_TOL
    assert res.evaluations == res.ledger.spent \
        == sum(n for _, n in res.ledger.entries) \
        == sum(h["evaluations"] for h in res.history) <= 64
    grid = golden_engine.grid(reserves=list(np.linspace(0.0, 1.0, 101)))
    assert res.evaluations < grid.num_scenarios // 2
    rev = golden_engine.sweep(grid).results.revenue.numpy()
    assert res.best_value >= rev.max() * 0.98


def test_search_over_boost_axis(golden_engine):
    eng = CounterfactualEngine(golden_engine.values, golden_engine.budgets,
                               AuctionRule.first_price(_GOLDEN_C,
                                                       device="cpu"),
                               device="cpu")
    res = eng.search(SearchSpace(campaign_boost={0: (0.5, 2.0)}),
                     method="hillclimb", budget=64)
    assert res.converged
    assert 1.9 < res.best_point["boost[0]"] <= 2.0
    base_rev = float(eng.sweep(eng.grid_from_points([{}])).results.revenue[0])
    assert res.best_value == pytest.approx(
        base_rev * res.best_point["boost[0]"], rel=1e-5)


def test_search_constraints_budget_and_errors(golden_engine):
    def impossible(swept):
        rev = swept.results.revenue.numpy().astype(np.float64)
        return -1.0 - rev / _GOLDEN_N

    space = SearchSpace(reserve=(0.0, 1.0))
    res = golden_engine.search(space, method="halving", budget=48,
                               constraints=(impossible,))
    assert not res.best_feasible
    assert min(res.best_point["reserve"],
               1 - res.best_point["reserve"]) < _R_TOL
    res = golden_engine.search(space, method="halving", budget=17,
                               num_candidates=16)
    assert not res.converged and res.evaluations <= 17
    with pytest.raises(ValueError, match="unknown search method"):
        golden_engine.search(space, method="anneal")
    with pytest.raises(ValueError, match="unknown objective"):
        golden_engine.search(space, objective="profit")
    # the execution plan is checked before any evaluation
    with pytest.raises(ValueError, match="unknown resolve back-end"):
        golden_engine.search(space, resolve="jnp")
    with pytest.raises(ValueError, match=r"driver='sharded' needs "
                       r"mesh=SweepMeshSpec"):
        golden_engine.search(space, driver="sharded")


def test_direct_optimizers():
    space = SearchSpace(bid_scale=(0.0, 2.0))

    def evaluate(points, note):
        xs = np.array([p["bid_scale"] for p in points])
        return -(xs - 1.3) ** 2, np.where(xs <= 1.8, 0.0, -1.0)

    res = successive_halving(evaluate, space, EvaluationLedger(budget=200))
    assert abs(res.best_point["bid_scale"] - 1.3) < 0.02
    res2 = coordinate_hillclimb(evaluate, space, EvaluationLedger(200),
                                init={"bid_scale": 0.2})
    assert abs(res2.best_point["bid_scale"] - 1.3) < 0.02 and res2.converged


@pytest.mark.parametrize("method,options", [
    ("hillclimb", dict(init={"reserve": 0.02, "budget_scale": 1.0})),
    ("halving", dict(num_candidates=9))])
def test_search_trajectory_is_repros(method, options):
    """On a synthetic day with budgets that bind, over reserve × budget
    scale under a cap-rate ceiling, the port's search and ``repro``'s
    visit the same points with the same scores and stop at the same best
    point; the port's inner sweeps run chunked."""
    env = make_synthetic_env(jax.random.PRNGKey(3),
                             n_events=2048, n_campaigns=8, emb_dim=4)
    j_engine = JEngine(env.values, env.budgets * jnp.float32(0.6))
    t_engine = CounterfactualEngine(
        torch.from_numpy(np.asarray(env.values).copy()),
        torch.from_numpy(np.array(env.budgets * jnp.float32(0.6))),
        device="cpu")
    kw = dict(method=method, budget=32, **options)
    want = j_engine.search(JSpace(reserve=(0.0, 0.3),
                                  budget_scale=(0.5, 1.5)),
                           constraints=(JCapRate(0.5),), **kw)
    got = t_engine.search(SearchSpace(reserve=(0.0, 0.3),
                                      budget_scale=(0.5, 1.5)),
                          constraints=(CapRateCeiling(0.5),),
                          chunks=ChunkSpec(512), **kw)
    assert got.best_point == want.best_point
    assert got.ledger.entries == want.ledger.entries
    assert [h["points"] for h in got.history] == \
        [h["points"] for h in want.history]
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g["values"], np.asarray(w["values"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(g["margins"], np.asarray(w["margins"]))
    assert got.best_value == pytest.approx(want.best_value, rel=1e-6)
    assert (got.converged, got.best_feasible) == \
        (want.converged, want.best_feasible)


def test_sharded_search_is_the_batched_search():
    """``engine.search(driver="sharded", mesh=...)`` on four CPU shards
    (and a 2 × 2 event × scenario mesh) visits the points of the batched
    search with the same scores: its inner sweeps are bitwise the batched
    sweeps."""
    from repro_torch.launch.mesh import SweepMeshSpec
    env = make_synthetic_env(jax.random.PRNGKey(3),
                             n_events=2048, n_campaigns=8, emb_dim=4)
    engine = CounterfactualEngine(
        torch.from_numpy(np.asarray(env.values).copy()),
        torch.from_numpy(np.array(env.budgets * jnp.float32(0.6))),
        device="cpu")
    space = SearchSpace(reserve=(0.0, 0.3), budget_scale=(0.5, 1.5))
    kw = dict(method="halving", budget=24, num_candidates=4,
              constraints=(CapRateCeiling(0.5),))
    want = engine.search(space, **kw)
    for shape in ((4,), (2, 2)):
        mesh = SweepMeshSpec.for_devices(*shape, devices=["cpu"] * 4)
        got = engine.search(space, driver="sharded", mesh=mesh, **kw)
        assert got.best_point == want.best_point
        assert [h["points"] for h in got.history] == \
            [h["points"] for h in want.history]
        for g, w in zip(got.history, want.history):
            np.testing.assert_array_equal(g["values"], w["values"])
            np.testing.assert_array_equal(g["margins"], w["margins"])
