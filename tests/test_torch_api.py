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
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              ScenarioGrid, SimResult, SweepPlan,
                              execute_sweep, pick_resolve, sequential_replay,
                              sweep_parallel, sweep_state_machine)
from repro_torch.core.executor import _unknown  # noqa: E402
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
                       r"\(choose from 'device', 'batched'\)"):
        SweepPlan(placement="gpu")


@pytest.fixture(scope="module")
def small():
    env = make_synthetic_env(3, n_events=512, n_campaigns=6, emb_dim=4,
                             device="cpu")
    engine = CounterfactualEngine(env.values, env.budgets, device="cpu")
    return env, engine, engine.grid(bid_scales=[1.0, 1.2])


@pytest.mark.parametrize("axis", [
    dict(method="naive_sampling"), dict(driver="sharded"),
    dict(driver="multihost"),
    dict(chunks=128), dict(scenario_chunks=1), dict(tuned=True),
    dict(mesh=object()),
])
def test_unported_sweep_axes_raise(small, axis):
    _, engine, grid = small
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        engine.sweep(grid, **axis)


def test_unported_entry_points_raise(small):
    env, engine, grid = small
    with pytest.raises(NotImplementedError, match="item 4"):
        engine.sweep(grid, method="naive_sampling")
    with pytest.raises(NotImplementedError, match="item 4"):
        engine.simulate(method="naive_sampling")
    with pytest.raises(NotImplementedError, match="item 5"):
        sweep_parallel(env.values, grid.budgets, grid.rules, overlay=object())
    with pytest.raises(NotImplementedError, match="item 3"):
        sweep_state_machine(env.values, grid.budgets, grid.rules, chunks=64)
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
