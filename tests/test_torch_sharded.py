"""The multi-GPU placements in the port against ``repro``, on the CPU.

``repro``'s sharded functions run once, in a subprocess with four fake
XLA CPU devices (the device count is fixed when jax starts, as in
tests/test_sharded_core.py), on ``repro.data.make_synthetic_env``'s day
(N=4,096, C=8, S=4, both pricing rules): ``sweep_sharded`` on 4×1 and 2×2
meshes and chunked, ``sweep_sort2aggregate_sharded``,
``sweep_first_crossing_sharded``, ``sharded_aggregate``,
``estimate_pi_sharded``, ``parallel_simulate`` fed by
``make_sharded_kernels``, and the engine's sharded SORT2AGGREGATE sweep
with its base warm start. The port runs each on ``["cpu"] * 4`` and is
held to the same bits: cap times exactly, and spends and pi too, because
the port adds the shards in rank order, the order of XLA's CPU
all-reduce.

In process, the port's sharded sweep is bitwise ``repro``'s batched sweep
over every back-end, chunks × sharding, scenario chunks and static and
per-event overlays; every error text added is ``repro``'s (its module
paths named as the port's).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as jsc  # noqa: E402
from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import executor as jex  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.launch.mesh import SweepMeshSpec as JSpec  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import scenarios as sc  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              ScenarioGrid, Segments, SweepPlan, execute_sweep,
                              parallel_simulate, sweep_parallel)
from repro_torch.core import executor  # noqa: E402
from repro_torch.core import sharded as sh  # noqa: E402
from repro_torch.interop import (family_from_reference,  # noqa: E402
                                 from_reference, key_from_reference,
                                 mesh_spec_from_reference)
from repro_torch.launch.mesh import (SweepMeshSpec, data_axes,  # noqa: E402
                                     event_sharding, make_mesh)

SRC = str(Path(__file__).resolve().parents[1] / "src")
N, C = 4096, 8
KINDS = ("first_price", "second_price")
CPU4 = ["cpu"] * 4
# (tag, mesh shape, event chunks) of the sharded sweeps held to repro's
SWEEPS = (("4x1", (4,), None), ("2x2", (2, 2), None), ("4x1c", (4,), 512))
PI_ARGS = dict(num_iters=40, local_batch=16, eta=0.5, eta_decay=0.01)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    assert len(jax.devices()) == 4
    from repro.data import make_synthetic_env
    from repro.core import (AuctionRule, CounterfactualEngine, ScenarioGrid,
                            Segments, parallel_simulate, sequential_replay)
    from repro.core import sharded as sh
    from repro.launch.mesh import SweepMeshSpec, make_mesh
    N, C = %d, %d
    env = make_synthetic_env(jax.random.PRNGKey(5), n_events=N,
                             n_campaigns=C, emb_dim=6)
    mesh = make_mesh((4,), ("data",))
    specs = {(4,): SweepMeshSpec(mesh),
             (2, 2): SweepMeshSpec.for_devices(2, 2)}
    vals = sh.shard_events(env.values, mesh)
    out = {"values": np.asarray(env.values),
           "budgets": np.asarray(env.budgets)}
    for kind in ("first_price", "second_price"):
        rule = AuctionRule(multipliers=env.rule.multipliers,
                           reserve=jnp.float32(0.02), kind=kind)
        grid = ScenarioGrid.product(rule, env.budgets, bid_scales=[1.0, 1.2],
                                    budget_scales=[1.0, 0.6])
        out[f"{kind}/mult"] = np.asarray(grid.rules.multipliers)
        out[f"{kind}/reserve"] = np.asarray(grid.rules.reserve)
        out[f"{kind}/grid_budgets"] = np.asarray(grid.budgets)
        for tag, shape, chunks in %r:
            res = sh.sweep_sharded(env.values, grid.budgets, grid.rules,
                                   specs[tuple(shape)], resolve="jnp",
                                   chunks=chunks)
            for i, a in enumerate(res):
                out[f"{kind}/sweep/{tag}/{i}"] = np.asarray(a)
        for tag, shape in (("4x1", (4,)), ("2x2", (2, 2))):
            r, gaps, iters = sh.sweep_sort2aggregate_sharded(
                env.values, grid.budgets, grid.rules, specs[shape],
                refine_iters=3)
            for name, a in (("spend", r.final_spend), ("caps", r.cap_times),
                            ("gaps", gaps), ("iters", iters)):
                out[f"{kind}/s2a/{tag}/{name}"] = np.asarray(a)
        out[f"{kind}/fc/caps"] = np.asarray(sh.sweep_first_crossing_sharded(
            env.values, jnp.asarray(out[f"{kind}/s2a/4x1/caps"]),
            grid.budgets, grid.rules, specs[(4,)]))
        oracle = sequential_replay(env.values, env.budgets, rule)
        segs = Segments.from_cap_times(oracle.cap_times, N)
        agg = sh.sharded_aggregate(mesh, vals, segs, env.budgets, rule)
        out[f"{kind}/agg/oracle_caps"] = np.asarray(oracle.cap_times)
        out[f"{kind}/agg/oracle_spend"] = np.asarray(oracle.final_spend)
        out[f"{kind}/agg/spend"] = np.asarray(agg.final_spend)
        out[f"{kind}/agg/caps"] = np.asarray(agg.cap_times)
        for coupling in ("shared", "independent"):
            pi = sh.estimate_pi_sharded(mesh, vals, env.budgets, rule,
                                        jax.random.PRNGKey(3),
                                        coupling=coupling, **%r)
            out[f"{kind}/pi/{coupling}"] = np.asarray(pi)
        rate_fn, block_fn = sh.make_sharded_kernels(mesh, rule)
        par = parallel_simulate(env.values, env.budgets, rule,
                                rate_fn=rate_fn(vals),
                                block_fn=block_fn(vals))
        out[f"{kind}/par/spend"] = np.asarray(par.final_spend)
        out[f"{kind}/par/caps"] = np.asarray(par.cap_times)
        eng = CounterfactualEngine(env.values, env.budgets, rule)
        sw = eng.sweep(grid, method="sort2aggregate", driver="sharded",
                       mesh=specs[(4,)], refine_iters=3)
        out[f"{kind}/engine/spend"] = np.asarray(sw.results.final_spend)
        out[f"{kind}/engine/caps"] = np.asarray(sw.results.cap_times)
        out[f"{kind}/engine/gaps"] = np.asarray(sw.consistency_gaps)
        out[f"{kind}/engine/iters"] = np.asarray(sw.refine_iters)
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
""") % (N, C, SWEEPS, PI_ARGS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """``repro``'s sharded outputs on four fake XLA CPU devices."""
    path = tmp_path_factory.mktemp("sharded") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "REFERENCE_OK" in out.stdout
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(got, want)


def _spec(shape):
    return SweepMeshSpec.for_devices(*shape, devices=CPU4)


def _port(ref, kind):
    """The day, the base design (reserve 0.02) and the grid in the port."""
    rules = AuctionRule(multipliers=_t(ref[f"{kind}/mult"]),
                        reserve=_t(ref[f"{kind}/reserve"]), kind=kind)
    rule = AuctionRule(multipliers=torch.ones(C),
                       reserve=torch.tensor(0.02, dtype=torch.float32),
                       kind=kind)
    return (_t(ref["values"]), _t(ref["budgets"]), rule, rules,
            _t(ref[f"{kind}/grid_budgets"]))


@pytest.mark.parametrize("tag,shape,chunks", SWEEPS,
                         ids=[s[0] for s in SWEEPS])
@pytest.mark.parametrize("kind", KINDS)
def test_sweep_sharded_is_repros(ref, kind, tag, shape, chunks):
    values, _, _, rules, budgets = _port(ref, kind)
    out = sh.sweep_sharded(values, budgets, rules, _spec(shape),
                           resolve="torch", chunks=chunks)
    for i, got in enumerate(out):
        _same(ref[f"{kind}/sweep/{tag}/{i}"], got)


@pytest.mark.parametrize("tag,shape", [("4x1", (4,)), ("2x2", (2, 2))])
@pytest.mark.parametrize("kind", KINDS)
def test_sort2aggregate_sharded_is_repros(ref, kind, tag, shape):
    """The sharded SORT2AGGREGATE sweep (3 refine iterations from the
    all-active start): cap times, gaps and iterations exactly, and the
    spends bitwise too — the shards' flat sums added in rank order, as
    XLA's CPU all-reduce adds them."""
    values, _, _, rules, budgets = _port(ref, kind)
    res, gaps, iters = sh.sweep_sort2aggregate_sharded(
        values, budgets, rules, _spec(shape), refine_iters=3)
    _same(ref[f"{kind}/s2a/{tag}/caps"], res.cap_times)
    _same(ref[f"{kind}/s2a/{tag}/gaps"], gaps)
    _same(ref[f"{kind}/s2a/{tag}/iters"], iters)
    _same(ref[f"{kind}/s2a/{tag}/spend"], res.final_spend)
    assert int((res.cap_times <= N).sum()) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_first_crossing_and_aggregate_sharded_are_repros(ref, kind):
    """``sweep_first_crossing_sharded`` at the S2A sweep's cap times, and
    ``sharded_aggregate`` at the exact replay's segments: the crossing of
    each shard scanned from the prefix of the shards before it, as one
    block. At the oracle's segments the aggregate finds the oracle's cap
    times (``repro``'s own check)."""
    values, budgets, rule, rules, grid_budgets = _port(ref, kind)
    mesh = make_mesh((4,), ("data",), devices=CPU4)
    caps = sh.sweep_first_crossing_sharded(
        values, _t(ref[f"{kind}/s2a/4x1/caps"]), grid_budgets, rules,
        _spec((4,)))
    _same(ref[f"{kind}/fc/caps"], caps)
    segs = Segments.from_cap_times(_t(ref[f"{kind}/agg/oracle_caps"]), N)
    log = sh.shard_events(values, mesh)
    agg = sh.sharded_aggregate(mesh, log, segs, budgets, rule)
    _same(ref[f"{kind}/agg/caps"], agg.cap_times)
    _same(ref[f"{kind}/agg/spend"], agg.final_spend)
    _same(ref[f"{kind}/agg/oracle_caps"], agg.cap_times)
    np.testing.assert_allclose(agg.final_spend.numpy(),
                               ref[f"{kind}/agg/oracle_spend"], rtol=1e-3,
                               atol=1e-3)
    _same(ref[f"{kind}/agg/caps"],
          sh.sharded_first_crossing(mesh, values, segs, budgets, rule))


@pytest.mark.parametrize("coupling", ["shared", "independent"])
@pytest.mark.parametrize("kind", KINDS)
def test_estimate_pi_sharded_is_repros(ref, kind, coupling):
    """Algorithm 4 at scale: each rank's minibatches drawn from its own
    rows (``fold_in(key, offset)``, ``randint``, ``uniform``), the
    residual summed over the ranks in rank order every step, the ``pmean``
    of the end — bit for bit."""
    values, budgets, rule, _, _ = _port(ref, kind)
    mesh = make_mesh((4,), ("data",), devices=CPU4)
    key = key_from_reference(np.asarray(jax.random.PRNGKey(3)))
    pi = sh.estimate_pi_sharded(mesh, values, budgets, rule, key,
                                coupling=coupling, **PI_ARGS)
    _same(ref[f"{kind}/pi/{coupling}"], pi)
    assert bool((pi > 0).any()) and bool((pi < 1).any())


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_kernels_drive_the_host_loop_like_repro(ref, kind):
    """``parallel_simulate(driver="host")`` fed ``make_sharded_kernels``:
    ``repro``'s bits, which are the one-device drivers' (the canonical
    partials of each shard add exact zeros)."""
    values, budgets, rule, _, _ = _port(ref, kind)
    mesh = make_mesh((4,), ("data",), devices=CPU4)
    rate_fn, block_fn = sh.make_sharded_kernels(mesh, rule)
    log = sh.shard_events(values, mesh)
    got = parallel_simulate(values, budgets, rule, rate_fn=rate_fn(log),
                            block_fn=block_fn(log))
    _same(ref[f"{kind}/par/spend"], got.final_spend)
    _same(ref[f"{kind}/par/caps"], got.cap_times)
    one = parallel_simulate(values, budgets, rule, driver="device")
    assert torch.equal(one.final_spend, got.final_spend)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_sharded_sort2aggregate_sweep_is_repros(ref, kind):
    """``engine.sweep(method="sort2aggregate", driver="sharded")``: the
    base warm start's Algorithm 4 (``estimate_pi_sharded`` at its defaults,
    200 steps of 64 rows a rank), its cap times, the base refinement on
    the mesh and every lane's refine and aggregate passes, bit for bit."""
    values, budgets, rule, rules, grid_budgets = _port(ref, kind)
    engine = CounterfactualEngine(values, budgets, rule, device="cpu")
    grid = ScenarioGrid(rules=rules, budgets=grid_budgets,
                        labels=tuple(f"s{i}" for i in range(4)))
    out = engine.sweep(grid, method="sort2aggregate", driver="sharded",
                       mesh=_spec((4,)), refine_iters=3)
    _same(ref[f"{kind}/engine/caps"], out.results.cap_times)
    _same(ref[f"{kind}/engine/gaps"], out.consistency_gaps)
    _same(ref[f"{kind}/engine/iters"], out.refine_iters)
    _same(ref[f"{kind}/engine/spend"], out.results.final_spend)


# ---------------------------------------------------------------------------
# in process: the sharded sweep is repro's batched sweep
# ---------------------------------------------------------------------------

_SMALL_N = 1024


def _small():
    env = make_synthetic_env(jax.random.PRNGKey(7), n_events=_SMALL_N,
                             n_campaigns=C, emb_dim=6)
    grid = JGrid.product(JRule.first_price(C, reserve=0.01), env.budgets,
                         bid_scales=[1.0, 0.9, 1.2],
                         budget_scales=[1.0, 0.6])
    return env, grid


@pytest.fixture(scope="module")
def small():
    env, grid = _small()
    want = {}
    for kind in KINDS:
        rules = JRule(multipliers=grid.rules.multipliers,
                      reserve=grid.rules.reserve, kind=kind)
        want[kind] = jex.execute_sweep(env.values, grid.budgets, rules,
                                       jex.SweepPlan(resolve="jnp"))
    return env, grid, want


@pytest.mark.parametrize("scenario_chunks", [None, 1])
@pytest.mark.parametrize("chunks", [None, 64])
@pytest.mark.parametrize("shape", [(4,), (2, 2)])
@pytest.mark.parametrize("resolve", ["torch", "sweep_resolve", "fused"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_sweep_is_repros_batched_sweep(small, kind, resolve, shape,
                                               chunks, scenario_chunks):
    """Every back-end, 4×1 and 2×2 meshes, chunks × sharding (each shard
    scanned in chunks of 64 rows) and scenario chunks: the six outputs of
    ``repro``'s batched sweep, bit for bit."""
    env, grid, want = small
    values, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        kind, device="cpu")
    out = execute_sweep(values, port_grid.budgets, port_grid.rules,
                        SweepPlan(placement="sharded", mesh=_spec(shape),
                                  resolve=resolve, chunks=chunks,
                                  scenario_chunks=scenario_chunks))
    for w, g in zip(want[kind], out):
        _same(w, g)


def _families():
    env = make_synthetic_env(jax.random.PRNGKey(3), n_events=512,
                             n_campaigns=C, emb_dim=6)
    specs = {
        "static": lambda m: [(m.PauseCampaign(3),), (m.BoostCampaign(1, 1.7),),
                             (m.PauseCampaign(0), m.SetReserve(0.05))],
        "noise": lambda m: [(m.BidNoise(0.3),
                             m.ParticipationJitter(0.8, campaign=2)),
                            (m.BudgetPacing(0, start=65, stop=257),
                             m.BidNoise(0.2, campaign=5))],
    }
    return env, specs


@pytest.mark.parametrize("name,resolve", [("static", "fused"),
                                          ("static", "torch"),
                                          ("noise", "torch")])
def test_overlay_families_sharded_are_repros(name, resolve):
    """A static family (pauses, a boost, a reserve: folded into the mask,
    every back-end) and a per-event one (bid noise, participation, a pacing
    window: the torch path, each shard's rows perturbed by their own CRN
    draws) swept on four CPU shards: ``repro``'s batched family sweep, bit
    for bit."""
    env, specs = _families()
    j_engine = JEngine(env.values, env.budgets, JRule.first_price(C))
    jfam = jsc.compile_family(env.values, env.budgets, j_engine.base_rule,
                              specs[name](jsc), key=jax.random.PRNGKey(5))
    want = j_engine.sweep(jfam, resolve="jnp")
    engine = CounterfactualEngine(np.array(env.values), np.array(env.budgets),
                                  AuctionRule.first_price(C, device="cpu"),
                                  device="cpu")
    family = family_from_reference(jfam, device="cpu")
    got = engine.sweep(family, resolve=resolve, driver="sharded",
                       mesh=_spec((4,)))
    _same(want.results.final_spend, got.results.final_spend)
    _same(want.results.cap_times, got.results.cap_times)
    # the port's own family on the port's key, sharded and chunked
    pfam = sc.compile_family(engine.values, engine.budgets, engine.base_rule,
                             specs[name](sc), key=key_from_reference(
                                 np.asarray(jax.random.PRNGKey(5))))
    chunked = engine.sweep(pfam, resolve=resolve, driver="sharded",
                           mesh=_spec((4,)), chunks=64)
    _same(want.results.final_spend, chunked.results.final_spend)


def test_sharded_log_input_and_views():
    """A :class:`ShardedLog` sweeps like the tensor it was split from; on
    one device its shards are views of that tensor (nothing copied); a log
    split over another shard count is put back together and split again."""
    values, port_grid = _port_small(*_small())
    spec = _spec((4,))
    log = event_sharding(spec).place(values)
    assert all(s.data_ptr() == values[off:].data_ptr()
               for off, s in zip(log.offsets, log.shards))
    want = execute_sweep(values, port_grid.budgets, port_grid.rules,
                         SweepPlan())
    for placed in (log, event_sharding(_spec((2,))).place(values)):
        got = execute_sweep(placed, port_grid.budgets, port_grid.rules,
                            SweepPlan(placement="sharded", mesh=spec))
        for w, g in zip(want, got):
            assert torch.equal(w, g)
    assert executor.shard_log(log, spec)[2][0] == 2 * _SMALL_N // 4


def _port_small(env, grid):
    return from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, device="cpu")


def test_sweep_parallel_and_state_machine_take_a_mesh():
    """``sweep_parallel`` and ``sweep_state_machine`` take ``driver=`` and
    ``mesh=`` (a 2 × 2 mesh here), with the batched sweep's bits."""
    values, g = _port_small(*_small())
    spec = _spec((2, 2))
    want = sweep_parallel(values, g.budgets, g.rules)
    got = sweep_parallel(values, g.budgets, g.rules, driver="sharded",
                         mesh=spec)
    assert torch.equal(want.final_spend, got.final_spend)
    from repro_torch.core import sweep_state_machine
    a = sweep_state_machine(values, g.budgets, g.rules, resolve="torch")
    b = sweep_state_machine(values, g.budgets, g.rules, resolve="torch",
                            driver="sharded", mesh=spec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# meshes and error texts
# ---------------------------------------------------------------------------

def test_mesh_spec_is_repros():
    """``SweepMeshSpec`` on a device list: its counts, ``plan()``, the
    row-major event coordinates, the spec carried from ``repro``'s, and
    ``for_devices``' texts."""
    spec = _spec((2, 2))
    j_spec = JSpec.for_devices()    # one device in this process
    assert (spec.event_device_count, spec.scenario_device_count) == (2, 2)
    assert spec.local_event_count(1000) == 500
    assert spec.plan(chunks=64).placement == "sharded"
    assert spec.plan(chunks=64).chunks.events_per_chunk == 64
    assert not spec.is_multiprocess
    assert data_axes(spec.mesh) == ("data",)
    three = SweepMeshSpec(make_mesh((2, 3), ("pod", "data"),
                                   devices=["cpu"] * 6),
                          event_axes=("pod", "data"))
    assert [three.event_coords(r) for r in (0, 4)] == \
        [{"pod": 0, "data": 0}, {"pod": 1, "data": 1}]
    carried = mesh_spec_from_reference(j_spec, devices=["cpu"])
    assert (carried.mesh.axis_names, carried.event_axes,
            carried.scenario_axis) == (tuple(j_spec.mesh.axis_names),
                                       tuple(j_spec.event_axes),
                                       j_spec.scenario_axis)
    n_dev = len(jax.devices())
    for args in ((None, 0), (n_dev + 1, 1), (None, n_dev + 1)):
        with pytest.raises(ValueError) as err:
            SweepMeshSpec.for_devices(*args, devices=["cpu"] * n_dev)
        with pytest.raises(ValueError) as j_err:
            JSpec.for_devices(*args)
        assert str(err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="unknown axes"):
        SweepMeshSpec(spec.mesh, event_axes=("pod",))
    with pytest.raises(ValueError, match="cannot also shard"):
        SweepMeshSpec(spec.mesh, event_axes=("data",), scenario_axis="data")


def _texts(port_fn, repro_fn):
    with pytest.raises(ValueError) as err:
        port_fn()
    with pytest.raises(ValueError) as j_err:
        repro_fn()
    assert str(err.value) == str(j_err.value).replace(
        "repro.launch", "repro_torch.launch").replace(
        "repro.core.segments", "repro_torch.core.segments")


class _FakeSpec:
    """``check_sharded_shapes`` reads only the counts and the axis name."""

    def __init__(self, d_ev, d_sc=1):
        self.event_device_count = d_ev
        self.scenario_device_count = d_sc
        self.scenario_axis = "model" if d_sc > 1 else None


@pytest.mark.parametrize("n,s,d_ev,d_sc", [
    (1001, 4, 4, 1),      # ragged shard
    (1000, 4, 4, 1),      # shards not on whole canonical blocks
    (1050, 4, 3, 1),      # no N aligns: 3 does not divide 32
    (1024, 3, 2, 2),      # ragged scenario shard
])
def test_check_sharded_shapes_texts_are_repros(n, s, d_ev, d_sc):
    values = torch.zeros((n, C))
    budgets = torch.zeros((s, C))
    rules = AuctionRule(multipliers=torch.ones((s, C)),
                        reserve=torch.zeros(s))
    j_rules = JRule(multipliers=jnp.ones((s, C)), reserve=jnp.zeros(s))
    _texts(lambda: executor.check_sharded_shapes(
        values, budgets, rules, _FakeSpec(d_ev, d_sc)),
        lambda: jex.check_sharded_shapes(
            jnp.zeros((n, C)), jnp.zeros((s, C)), j_rules,
            _FakeSpec(d_ev, d_sc)))


def test_placement_and_option_texts_are_repros():
    spec = _spec((4,))
    j_spec = JSpec.for_devices()
    values = torch.zeros((64, C))
    for placement in ("sharded", "multihost"):
        _texts(lambda: SweepPlan(placement=placement),
               lambda: jex.SweepPlan(placement=placement))
        _texts(lambda: executor.plan_for_driver(placement),
               lambda: jex.plan_for_driver(placement))
    _texts(lambda: executor.plan_for_driver("pod"),
           lambda: jex.plan_for_driver("pod"))
    s2a = [(dict(placement="multihost"), False),
           (dict(placement="sharded", chunks=64), False),
           (dict(placement="sharded"), True)]
    for kw, record in s2a:
        _texts(lambda: executor.check_s2a_options(
            SweepPlan(mesh=spec, **kw), record),
            lambda: jex.check_s2a_options(jex.SweepPlan(mesh=j_spec, **kw),
                                          record))
    _texts(lambda: executor.check_host_stream(
        SweepPlan(placement="sharded", mesh=spec, chunks=64)),
        lambda: jex.check_host_stream(jex.SweepPlan(
            placement="sharded", mesh=j_spec, chunks=64)))
    engine = CounterfactualEngine(values, torch.ones(C), device="cpu")
    j_engine = JEngine(jnp.zeros((64, C)), jnp.ones(C))
    _texts(lambda: engine.sweep(engine.grid(), method="sequential",
                                driver="sharded", mesh=spec),
           lambda: j_engine.sweep(j_engine.grid(), method="sequential",
                                  driver="sharded", mesh=j_spec))
    with pytest.raises(ValueError, match="record_events is not supported "
                       "with driver='sharded'"):
        engine.sweep(engine.grid(), method="sort2aggregate",
                     driver="sharded", mesh=spec, record_events=True)


def test_sharded_draws_follow_the_shard():
    """A rank's Algorithm-4 draws are ``repro``'s per-device draws:
    ``fold_in(key, offset)``, one key a step, each split into the rows'
    ``randint`` and the uniforms — held here to ``jax.random`` directly."""
    key = jax.random.PRNGKey(11)
    dev_key = jax.random.fold_in(key, 768)
    keys = jax.random.split(dev_key, 5)
    want_rows, want_u = [], []
    for k in keys:
        k_idx, k_u = jax.random.split(k)
        want_rows.append(np.asarray(jax.random.randint(k_idx, (16,), 0, 256)))
        want_u.append(np.asarray(jax.random.uniform(k_u, (16, 1))))
    rows, u = sh._shard_draws(key_from_reference(np.asarray(key)), 768, 256,
                              num_iters=5, local_batch=16, width=1)
    np.testing.assert_array_equal(rows.numpy(), np.stack(want_rows))
    np.testing.assert_array_equal(u.numpy(), np.stack(want_u))
    assert prng.randint(key_from_reference(np.asarray(key)), (3,), 0,
                        9).shape == (3,)
