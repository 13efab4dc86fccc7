"""The port's Algorithm-2 sweep against ``repro``'s on the golden env of
``tests/test_scenario_sweep.py`` (PRNGKey(1), N=4096, C=16, d=8): every
output of the batched loop bit for bit, the delta table row for row, and
each lane within the oracle tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import sweep_sequential as j_sweep_sequential  # noqa: E402
from repro.core import sweep_state_machine as j_ssm  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              SweepPlan, execute_sweep, sweep_parallel,
                              sweep_state_machine)
from repro_torch.interop import from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS = 4096
N_CAMPAIGNS = 16
ORACLE_TOL = 0.08      # tests/test_scenario_sweep.py's oracle budget
OUTPUTS = ("final_spend", "cap_times", "retired", "boundaries", "num_rounds",
           "n_hat")


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(1), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


def _grids(env):
    """The golden grids: both pricing rules, a tie-heavy budget set (equal
    budgets -> many campaigns predicted to cap in the same round) and a
    skewed grid whose lanes freeze at very different rounds."""
    first = JRule.first_price(N_CAMPAIGNS)
    second = JRule.second_price(N_CAMPAIGNS)
    ties = jnp.full((N_CAMPAIGNS,), float(env.budgets[N_CAMPAIGNS // 2]))
    scales = dict(bid_scales=[1.0, 0.9, 1.1, 1.3], reserves=[0.0, 0.05])
    return {
        "first": JGrid.product(first, env.budgets, **scales),
        "second": JGrid.product(second, env.budgets, **scales),
        "first_ties": JGrid.product(first, ties, bid_scales=[1.0, 1.1],
                                    reserves=[0.0, 0.05]),
        "second_ties": JGrid.product(second, ties, bid_scales=[1.0, 1.1],
                                     reserves=[0.0, 0.05]),
        "skewed": JGrid.product(first, env.budgets, bid_scales=[1.0, 1.2],
                                budget_scales=[1.0, 0.25, 1e6]),
    }


def _port(env, grid):
    return from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device="cpu")


@pytest.fixture(scope="module")
def reference(env):
    """repro's jnp sweep of every golden grid (compiled once per grid)."""
    out = {}
    for name, grid in _grids(env).items():
        out[name] = [np.asarray(x) for x in j_ssm(
            env.values, grid.budgets, grid.rules, resolve="jnp")]
    return out


@pytest.mark.parametrize("grid_name", ["first", "second", "first_ties",
                                       "second_ties", "skewed"])
@pytest.mark.parametrize("resolve", ["torch", "sweep_resolve", "fused"])
def test_sweep_state_machine_bitwise_the_reference(env, reference,
                                                   grid_name, resolve):
    """All six outputs equal, dtypes included. ``"sweep_resolve"`` and
    ``"fused"`` on CPU tensors run their kernels' plain versions: the same
    bits."""
    values, grid = _port(env, _grids(env)[grid_name])
    out = sweep_state_machine(values, grid.budgets, grid.rules,
                              resolve=resolve)
    for name, a, b in zip(OUTPUTS, reference[grid_name], out):
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_sweep_parallel_and_device_placement_match(env, reference):
    values, grid = _port(env, _grids(env)["second"])
    sw = sweep_parallel(values, grid.budgets, grid.rules, resolve="torch")
    np.testing.assert_array_equal(reference["second"][0],
                                  sw.final_spend.numpy())
    np.testing.assert_array_equal(reference["second"][1],
                                  sw.cap_times.numpy())
    for s in (0, 5):
        rule, budgets = grid.scenario(s)
        solo = execute_sweep(values, budgets, rule,
                             SweepPlan(placement="device", resolve="torch"))
        for name, a, b in zip(OUTPUTS, reference["second"], solo):
            np.testing.assert_array_equal(a[s], b.numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_engine_delta_table_equal_row_for_row(env, kind):
    j_engine = JEngine(env.values, env.budgets,
                       base_rule=(JRule.first_price(N_CAMPAIGNS)
                                  if kind == "first_price"
                                  else JRule.second_price(N_CAMPAIGNS)))
    axes = dict(bid_scales=[1.0, 1.1, 0.8], reserves=[0.0, 0.02],
                budget_scales=[1.0, 0.5])
    j_table = j_engine.sweep(j_engine.grid(**axes), method="parallel",
                             resolve="jnp").delta_table()
    base = (AuctionRule.first_price(N_CAMPAIGNS, device="cpu")
            if kind == "first_price"
            else AuctionRule.second_price(N_CAMPAIGNS, device="cpu"))
    t_engine = CounterfactualEngine(np.array(env.values),
                                    np.array(env.budgets), base_rule=base,
                                    device="cpu")
    t_sweep = t_engine.sweep(t_engine.grid(**axes), method="parallel")
    t_table = t_sweep.delta_table()
    assert len(t_table) == len(j_table)
    for t_row, j_row in zip(t_table, j_table):
        # revenue is the float32 sum of final_spend over campaigns:
        # final_spend is bitwise, but XLA and torch.sum add the 16 campaigns
        # in different orders, so revenue (and the lift derived from it)
        # agree to rtol 1e-6 only. Every other column is exact.
        np.testing.assert_allclose(t_row.pop("revenue"),
                                   j_row.pop("revenue"), rtol=1e-6)
        np.testing.assert_allclose(t_row.pop("revenue_lift"),
                                   j_row.pop("revenue_lift"), rtol=1e-6,
                                   atol=1e-6)
        assert t_row == j_row
    assert "bid×1.1 res=0.02 bud×0.5" in t_sweep.format_delta_table()


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_each_lane_within_oracle_tolerance(env, kind):
    grid = _grids(env)["first" if kind == "first_price" else "second"]
    oracle = np.asarray(j_sweep_sequential(env.values, grid.budgets,
                                           grid.rules).final_spend)
    values, t_grid = _port(env, grid)
    sw = sweep_parallel(values, t_grid.budgets, t_grid.rules)
    for s in range(grid.num_scenarios):
        rel = np.abs(sw.final_spend[s].numpy() - oracle[s]) \
            / np.maximum(oracle[s], 1e-9)
        assert rel.mean() < ORACLE_TOL, (grid.labels[s], rel.mean())


def test_engine_sequential_sweep_is_the_reference_oracle(env):
    j_engine = JEngine(env.values[:512], env.budgets / 8)
    j_grid = j_engine.grid(bid_scales=[1.0, 1.2])
    j_res = j_engine.sweep(j_grid, method="sequential").results
    t_engine = CounterfactualEngine(np.array(env.values[:512]),
                                    np.array(env.budgets / 8), device="cpu")
    t_res = t_engine.sweep(t_engine.grid(bid_scales=[1.0, 1.2]),
                           method="sequential").results
    np.testing.assert_array_equal(np.asarray(j_res.final_spend),
                                  t_res.final_spend.numpy())
    np.testing.assert_array_equal(np.asarray(j_res.cap_times),
                                  t_res.cap_times.numpy())
