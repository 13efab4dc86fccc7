"""The port's boundaries: what it imports, which device it picks, and the
errors it raises for options it does not know or has not ported yet."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.executor import _unknown as j_unknown  # noqa: E402
from repro_torch import pick_device  # noqa: E402
from repro_torch.configs.paper_auction import (PAPER_SYNTHETIC_CPU,  # noqa: E402
                                               PAPER_SYNTHETIC_FULL)
from repro_torch.core import (AuctionRule, ChunkSpec,  # noqa: E402
                              CounterfactualEngine, ScenarioGrid, SimResult,
                              SweepPlan,
                              execute_sweep, pick_resolve, sequential_replay,
                              sweep_parallel, sweep_state_machine)
from repro_torch.core.executor import _unknown  # noqa: E402
from repro_torch.core.types import ScenarioOverlay  # noqa: E402
from repro_torch.data import make_synthetic_env  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_unknown_options_raise_the_reference_message():
    assert str(_unknown("resolve back-end", "cuda", ("torch", "fused"))) \
        == str(j_unknown("resolve back-end", "cuda", ("torch", "fused")))
    with pytest.raises(ValueError, match=r"unknown resolve back-end: 'cuda' "
                       r"\(choose from 'torch', 'sweep_resolve', 'fused', "
                       r"'auto'\)"):
        SweepPlan(resolve="cuda")
    with pytest.raises(ValueError, match=r"unknown resolve back-end: 'jnp'"):
        pick_resolve("jnp", "cpu")
    with pytest.raises(ValueError, match=r"unknown placement: 'gpu' "
                       r"\(choose from 'device', 'batched', 'sharded', "
                       r"'multihost'\)"):
        SweepPlan(placement="gpu")


@pytest.fixture(scope="module")
def small():
    env = make_synthetic_env(3, n_events=512, n_campaigns=6, emb_dim=4,
                             device="cpu")
    engine = CounterfactualEngine(env.values, env.budgets, device="cpu")
    return env, engine, engine.grid(bid_scales=[1.0, 1.2])


def _cpu_mesh(*shape):
    from repro_torch.launch.mesh import SweepMeshSpec
    return SweepMeshSpec.for_devices(*shape, devices=["cpu"] * 4)


@pytest.mark.parametrize("axis", [
    dict(driver="sharded"), dict(driver="multihost"),
    dict(tuned=True), dict(mesh=object()),
])
def test_unported_sweep_axes_raise(small, axis):
    """The multi-GPU axes run (the name is the item-8 tests'): a sharded
    sweep on four CPU shards and a one-process multihost sweep are bitwise
    the batched sweep, a mesh without a mesh driver is ignored (as
    ``repro``'s ``plan_for_driver`` drops it), and a mesh driver without a
    mesh raises ``repro``'s text. ``tuned=True`` (tuning) runs too: the
    plan resolved by the cost model is bitwise the default plan."""
    from repro.core.executor import plan_for_driver as j_plan
    from repro_torch.launch.mesh import SweepMeshSpec
    _, engine, grid = small
    want = engine.sweep(grid)
    if "driver" in axis:
        with pytest.raises(ValueError) as err:
            engine.sweep(grid, **axis)
        with pytest.raises(ValueError) as j_err:
            j_plan(axis["driver"])
        assert str(err.value) == str(j_err.value).replace(
            "repro.launch", "repro_torch.launch")
        mesh = (_cpu_mesh() if axis["driver"] == "sharded"
                else SweepMeshSpec.for_processes(device="cpu"))
        got = engine.sweep(grid, mesh=mesh, **axis)
    else:
        got = engine.sweep(grid, **axis)
    assert torch.equal(got.results.final_spend, want.results.final_spend)
    assert torch.equal(got.results.cap_times, want.results.cap_times)


@pytest.mark.parametrize("prefetch", [True, False])
def test_host_streamed_engine_sweep_is_repros(small, prefetch):
    """``engine.sweep(grid, chunks=ChunkSpec(..., source="host"))``: the
    log copied to host memory once and streamed back chunk by chunk, the
    answers ``repro``'s host-streamed sweep's bits."""
    import jax.numpy as jnp
    from repro.core import AuctionRule as JRule
    from repro.core import CounterfactualEngine as JEngine
    from repro.core import ScenarioGrid as JGrid
    from repro.core.executor import ChunkSpec as JChunkSpec
    env, engine, grid = small
    got = engine.sweep(grid, chunks=ChunkSpec(128, source="host",
                                              prefetch=prefetch))
    j_grid = JGrid(rules=JRule(
        multipliers=jnp.asarray(grid.rules.multipliers.numpy()),
        reserve=jnp.asarray(grid.rules.reserve.numpy()),
        kind=grid.rules.kind), budgets=jnp.asarray(grid.budgets.numpy()),
        labels=grid.labels)
    want = JEngine(jnp.asarray(env.values.numpy()),
                   jnp.asarray(env.budgets.numpy())).sweep(
        j_grid, chunks=JChunkSpec(128, source="host"))
    np.testing.assert_array_equal(got.results.final_spend.numpy(),
                                  np.asarray(want.results.final_spend))
    np.testing.assert_array_equal(got.results.cap_times.numpy(),
                                  np.asarray(want.results.cap_times))


def test_unported_entry_points_raise(small):
    env, engine, grid = small
    with pytest.raises(ValueError) as err:
        engine.sweep(grid, method="naive_sampling")
    assert str(err.value) == "unknown sweep method: naive_sampling"
    # the overlay is ported: a pause and a participation coin run as
    # repro runs them, bit for bit
    import jax.numpy as jnp
    from repro.core import AuctionRule as JRule
    from repro.core import ScenarioOverlay as JOverlay
    from repro.core import sweep_parallel as j_sweep_parallel
    n, c = env.values.shape
    stop = np.full((2, c), n, np.int32)
    stop[1, 1] = 0
    prob = np.full((2, c), 0.7, np.float32)
    key = np.array([0, 7], np.uint32)
    got = sweep_parallel(
        env.values, grid.budgets, grid.rules, resolve="torch",
        overlay=ScenarioOverlay(
            live_start=torch.zeros((2, c), dtype=torch.int32),
            live_stop=torch.from_numpy(stop),
            part_prob=torch.from_numpy(prob),
            key=torch.from_numpy(key.astype(np.int64))))
    want = j_sweep_parallel(
        jnp.asarray(env.values.numpy()), jnp.asarray(grid.budgets.numpy()),
        JRule(multipliers=jnp.asarray(grid.rules.multipliers.numpy()),
              reserve=jnp.asarray(grid.rules.reserve.numpy()),
              kind=grid.rules.kind), resolve="jnp",
        overlay=JOverlay(live_start=jnp.zeros((2, c), jnp.int32),
                         live_stop=jnp.asarray(stop),
                         part_prob=jnp.asarray(prob), key=jnp.asarray(key)))
    np.testing.assert_array_equal(got.final_spend.numpy(),
                                  np.asarray(want.final_spend))
    np.testing.assert_array_equal(got.cap_times.numpy(),
                                  np.asarray(want.cap_times))
    assert got.final_spend[1, 1] == 0
    chunked = sweep_state_machine(env.values, grid.budgets, grid.rules,
                                  chunks=64)
    for a, b in zip(sweep_state_machine(env.values, grid.budgets,
                                        grid.rules), chunked):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown sweep method"):
        engine.sweep(grid, method="magic")


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    values = torch.rand(64, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        CounterfactualEngine(values, torch.ones(4))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_synthetic_env(0, n_events=64, n_campaigns=4, emb_dim=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AuctionRule.first_price(4)
    assert pick_device("cpu") == torch.device("cpu")


def test_pick_resolve_auto_follows_the_device():
    assert pick_resolve("auto", torch.device("cpu")) == "torch"
    assert pick_resolve("auto", torch.device("cuda")) == "fused"
    assert pick_resolve("fused", "cpu") == "fused"


def test_from_reference_copies_read_only_arrays():
    values = np.arange(12, dtype=np.float32).reshape(4, 3)
    values.flags.writeable = False
    budgets = np.ones((2, 3), np.float32)
    mult = np.full((2, 3), 1.5, np.float32)
    t_values, grid = from_reference(values, budgets, mult,
                                    np.array([0.0, 0.1], np.float32),
                                    "second_price", device="cpu")
    t_values[0, 0] = 99.0
    assert values[0, 0] == 0.0
    assert grid.labels == ("scenario0", "scenario1")
    assert grid.rules.kind == "second_price"
    np.testing.assert_array_equal(grid.rules.multipliers.numpy(), mult)
    assert grid.rules.reserve.dtype == torch.float32


def test_synthetic_env_is_seeded_and_calibrated():
    a = make_synthetic_env(5, n_events=2048, n_campaigns=8, emb_dim=4,
                           device="cpu")
    b = make_synthetic_env(5, n_events=2048, n_campaigns=8, emb_dim=4,
                           block=500, device="cpu")
    assert torch.equal(a.event_emb, b.event_emb)
    torch.testing.assert_close(a.values, b.values)
    assert a.values.shape == (2048, 8) and a.values.dtype == torch.float32
    assert float(a.values.max()) <= 1.0 and float(a.values.min()) > 0.0
    torch.testing.assert_close(a.budgets / a.budgets[0],
                               torch.arange(1, 9, dtype=torch.float32))
    fixed = make_synthetic_env(5, n_events=256, n_campaigns=4, emb_dim=4,
                               b_base=70.0, device="cpu")
    assert fixed.budgets.tolist() == [70.0, 140.0, 210.0, 280.0]
    assert (PAPER_SYNTHETIC_FULL.n_events, PAPER_SYNTHETIC_FULL.n_campaigns,
            PAPER_SYNTHETIC_FULL.emb_dim, PAPER_SYNTHETIC_FULL.b_base) \
        == (1_000_000, 100, 10, 70.0)
    assert PAPER_SYNTHETIC_CPU.b_base is None


def test_simulate_sequential_and_result_helpers(small):
    env, engine, grid = small
    res = engine.simulate(method="sequential")
    ref = sequential_replay(env.values, env.budgets, engine.base_rule)
    assert torch.equal(res.final_spend, ref.final_spend)
    assert torch.equal(res.cap_times, ref.cap_times)
    assert res.batch_size is None
    assert float(res.revenue) == pytest.approx(float(res.prices.sum()))
    sw = engine.sweep(grid, method="parallel").results
    assert isinstance(sw, SimResult) and sw.batch_size == 2
    lane = sw.scenario(1)
    assert torch.equal(lane.final_spend, sw.final_spend[1])
    assert sw.num_capped(512).shape == (2,)
    rule, budgets = grid.scenario(0)
    solo = execute_sweep(env.values, budgets, rule,
                         SweepPlan(placement="device"))
    assert torch.equal(solo[0], sw.final_spend[0])
    assert solo[1].dtype == torch.int32


def test_grid_and_batch_validation(small):
    env, engine, grid = small
    with pytest.raises(ValueError, match="inconsistent grid"):
        ScenarioGrid(rules=grid.rules, budgets=grid.budgets, labels=("a",))
    with pytest.raises(ValueError, match="must be batched"):
        sweep_parallel(env.values, env.budgets, engine.base_rule)
    with pytest.raises(ValueError, match="one pricing rule"):
        ScenarioGrid.from_scenarios([
            (AuctionRule.first_price(6, device="cpu"), env.budgets),
            (AuctionRule.second_price(6, device="cpu"), env.budgets)])
    rule = AuctionRule.first_price(6, device="cpu").with_multiplier(2, 1.5)
    assert rule.multipliers.tolist() == [1, 1, 1.5, 1, 1, 1]
    assert rule.scaled(2.0).multipliers.tolist() == [2, 2, 3, 2, 2, 2]
