"""The multihost placement in the port (``placement="multihost"``).

Two ``torch.distributed`` processes on the CPU (the ``gloo`` backend),
each holding only its contiguous half of the event log, sweep it on every
back-end, chunked and not, and through ``engine.sweep(driver=
"multihost")``: every rank's outputs are bitwise ``repro``'s batched sweep
of the whole log (as tests/test_multihost.py holds ``repro``'s own
two-process run). In one process the placement degenerates to a one-shard
mesh, bitwise the batched sweep, and it keeps ``repro``'s refusals.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.launch.mesh import SweepMeshSpec as JSpec  # noqa: E402
from repro_torch.core import (CounterfactualEngine, SweepPlan,  # noqa: E402
                              execute_sweep)
from repro_torch.core import executor  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.launch.mesh import SweepMeshSpec  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
N, C = 1024, 8
CELLS = [(r, ch) for r in ("torch", "sweep_resolve", "fused")
         for ch in (None, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _day(kind="first_price"):
    env = make_synthetic_env(jax.random.PRNGKey(3), n_events=N,
                             n_campaigns=C, emb_dim=6)
    grid = JGrid.product(JRule.first_price(C, reserve=0.01), env.budgets,
                         bid_scales=[1.0, 1.2], budget_scales=[1.0, 0.6])
    rules = JRule(multipliers=grid.rules.multipliers,
                  reserve=grid.rules.reserve, kind=kind)
    want = jex.execute_sweep(env.values, grid.budgets, rules,
                             jex.SweepPlan(resolve="jnp"))
    values, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        kind, device="cpu")
    return values, port_grid, want


WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    torch.set_num_threads(1)
    rank, address, inputs, outputs = (int(sys.argv[1]), sys.argv[2],
                                      sys.argv[3], sys.argv[4])
    from repro_torch.core import (AuctionRule, CounterfactualEngine,
                                  ScenarioGrid, SweepPlan, execute_sweep)
    from repro_torch.core import executor
    from repro_torch.launch.mesh import (SweepMeshSpec,
                                         distributed_initialize)
    assert distributed_initialize(address, 2, rank, device="cpu") == "gloo"
    spec = SweepMeshSpec.for_processes(device="cpu")
    assert spec.is_multiprocess and spec.event_device_count == 2
    data = np.load(inputs)
    values = torch.from_numpy(data["values"])
    half = values.shape[0] // 2
    local = values[rank * half:(rank + 1) * half].clone()
    out = {}
    for kind in ("first_price", "second_price"):
        rules = AuctionRule(multipliers=torch.from_numpy(data["mult"]),
                            reserve=torch.from_numpy(data["reserve"]),
                            kind=kind)
        budgets = torch.from_numpy(data["budgets"])
        for resolve, chunks in %r:
            executor.reset_collectives()
            res = execute_sweep(local, budgets, rules, SweepPlan(
                placement="multihost", mesh=spec, resolve=resolve,
                chunks=chunks))
            rounds = int(res[4].max())
            # two all-reduces a round (rate and block partials)
            assert executor.COLLECTIVES["all_reduce"] == 2 * rounds, \\
                (executor.COLLECTIVES, rounds)
            for i, a in enumerate(res):
                out[f"{kind}/{resolve}/{chunks}/{i}"] = a.numpy()
        grid = ScenarioGrid(rules=rules, budgets=budgets,
                            labels=tuple(f"s{i}" for i in range(4)))
        engine = CounterfactualEngine(local, budgets[0], device="cpu")
        sw = engine.sweep(grid, driver="multihost", mesh=spec)
        out[f"{kind}/engine/spend"] = sw.results.final_spend.numpy()
        out[f"{kind}/engine/caps"] = sw.results.cap_times.numpy()
    np.savez(outputs, **out)
    torch.distributed.destroy_process_group()
    print("MULTIHOST_OK", rank)
""") % (CELLS,)


def test_two_gloo_processes_are_the_batched_sweep(tmp_path):
    """Two processes, each holding its 512 rows of a 1,024-event log: every
    cell's six outputs on both ranks are ``repro``'s batched sweep of the
    whole log, bit for bit, with one all-reduce a pass."""
    days = {kind: _day(kind) for kind in ("first_price", "second_price")}
    values, grid, _ = days["first_price"]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, values=values.numpy(), budgets=grid.budgets.numpy(),
             mult=grid.rules.multipliers.numpy(),
             reserve=grid.rules.reserve.numpy())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), address, str(inputs),
         str(tmp_path / f"rank{rank}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {stderr[-3000:]}"
        assert f"MULTIHOST_OK {rank}" in stdout
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            for kind, (_, _, want) in days.items():
                for resolve, chunks in CELLS:
                    for i, w in enumerate(want):
                        np.testing.assert_array_equal(
                            got[f"{kind}/{resolve}/{chunks}/{i}"],
                            np.asarray(w), err_msg=f"rank {rank} {kind} "
                            f"{resolve} {chunks} output {i}")
                np.testing.assert_array_equal(got[f"{kind}/engine/spend"],
                                              np.asarray(want[0]))
                np.testing.assert_array_equal(got[f"{kind}/engine/caps"],
                                              np.asarray(want[1]))


def test_one_process_multihost_is_the_batched_sweep():
    """Without a process group ``for_processes`` is a one-shard mesh of
    this process: the multihost sweep is the batched sweep, bit for bit,
    and makes no collective."""
    values, grid, want = _day()
    spec = SweepMeshSpec.for_processes(device="cpu")
    assert not spec.is_multiprocess and spec.event_device_count == 1
    executor.reset_collectives()
    got = execute_sweep(values, grid.budgets, grid.rules,
                        SweepPlan(placement="multihost", mesh=spec))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert executor.COLLECTIVES["all_reduce"] == 0


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_multihost_refusals_are_repros():
    """``repro``'s refusals: no scenario axis across processes, no
    overlay, no SORT2AGGREGATE; a mesh whose shard count is not the
    world's is refused too."""
    from types import SimpleNamespace
    from repro_torch.core.types import ScenarioOverlay
    values, grid, _ = _day()

    def repro_text(scenario_axis, overlay):
        plan = jex.SweepPlan(placement="multihost", mesh=SimpleNamespace(
            scenario_axis=scenario_axis))
        return _message(lambda: jex._sweep_multihost(None, None, None,
                                                     overlay, plan))

    two_by_two = SweepMeshSpec.for_devices(2, 2, devices=["cpu"] * 4)
    assert _message(lambda: execute_sweep(
        values, grid.budgets, grid.rules,
        SweepPlan(placement="multihost", mesh=two_by_two))) == \
        repro_text("model", None)
    overlay = ScenarioOverlay(
        live_start=torch.zeros((4, C), dtype=torch.int32),
        live_stop=torch.full((4, C), N, dtype=torch.int32))
    spec = SweepMeshSpec.for_processes(device="cpu")
    assert _message(lambda: execute_sweep(
        values, grid.budgets, grid.rules,
        SweepPlan(placement="multihost", mesh=spec), overlay=overlay)) == \
        repro_text(None, object())
    engine = CounterfactualEngine(values, grid.budgets[0], device="cpu")
    assert _message(lambda: engine.sweep(
        grid, method="sort2aggregate", driver="multihost", mesh=spec)) == \
        _message(lambda: jex.check_s2a_options(jex.SweepPlan(
            placement="multihost", mesh=JSpec.for_devices())))
    with pytest.raises(ValueError, match="event shards but the "
                       "torch.distributed world has 1"):
        execute_sweep(values, grid.budgets, grid.rules, SweepPlan(
            placement="multihost", mesh=SweepMeshSpec.for_devices(
                devices=["cpu"] * 2)))
