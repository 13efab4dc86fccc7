"""The port's plan tuner (``repro_torch.tune``) against ``repro.tune``, at
``tests/test_tune.py``'s size (N=2,048, C=16, S=4), on the same inputs.

Four contracts, as in ``repro``:

* the tuning cache round-trips winners, reads a corrupt or other-schema
  file as empty (the cost model answers) and checks a cached winner
  against the exact shape; its keys and its file format are ``repro``'s,
  so either package reads the other's file;
* the candidate lattice and its ranking are deterministic, legal by the
  executor's own checks, never move a pinned knob, and on CUDA the fused
  round's shared memory is a hard gate (small limits injected here, so no
  kernel is built); on the CPU the lattice and the ranking are ``repro``'s,
  config for config;
* a tuned plan's outputs are the default plan's bit for bit in every
  placement × back-end cell (the plain versions of the kernels), also
  through a cached winner that chunks events and scenarios;
* ``engine.tune`` / ``sweep(tuned=True)`` / ``block_t="auto"``, the
  service's ``tuned`` and ``tune()``, and the resumable and SORT2AGGREGATE
  entry points (which run a tuned plan at the defaults).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import tune as j_tune  # noqa: E402
from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import executor as j_ex  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.launch.roofline import HARDWARE as J_HARDWARE  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.core import AuctionRule, CounterfactualEngine  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.launch.mesh import SweepMeshSpec  # noqa: E402
from repro_torch.launch.roofline import HARDWARE, HardwareSpec  # noqa: E402
from repro_torch.tune import space  # noqa: E402

N_EVENTS = 2048
N_CAMPAIGNS = 16
OUTPUTS = ("final_spend", "cap_times", "retired", "boundaries", "num_rounds",
           "n_hat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test has its own cache files; nothing reaches the cwd."""
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune_torch.json"))
    monkeypatch.setenv(j_tune.ENV_VAR, str(tmp_path / "tune.json"))


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(3), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


@pytest.fixture(scope="module")
def port(env):
    """The port's values, base budgets and a 4-lane grid (bid × budget)."""
    grid = JGrid.product(JRule.first_price(N_CAMPAIGNS), env.budgets,
                         bid_scales=[1.0, 1.3], budget_scales=[1.0, 0.5])
    values, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device="cpu")
    return values, torch.from_numpy(np.array(env.budgets)), port_grid


def _tuned_plan(**kw):
    return ex.SweepPlan(block_t="auto", tuned=True, **kw)


def _shape(plan, s=4, **kw):
    return tune.shape_for(plan, n_events=N_EVENTS, n_campaigns=N_CAMPAIGNS,
                          n_scenarios=s, device=kw.pop("device", "cpu"), **kw)


def _same_outputs(got, want, what):
    for name, a, b in zip(OUTPUTS, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {name}"


# ---------------------------------------------------------------------------
# (a) the cache
# ---------------------------------------------------------------------------

def test_cache_round_trip(tmp_path):
    path = tmp_path / "cache.json"
    cache = tune.TuningCache.load(path)
    assert cache.entries == {}
    key = "cpu|d1|N2048|C16|S4|batched|torch|device"
    cache.put(key, {"block_t": 512, "scenarios_per_chunk": 2},
              us_tuned=10.0, hardware="cpu")
    cache.save()
    entry = tune.TuningCache.load(path).get(key)
    assert entry["config"]["block_t"] == 512
    assert entry["origin"] == "measured"
    assert entry["us_tuned"] == 10.0
    # unknown keys in a cached config (a newer writer) are ignored
    assert tune.candidate_from_config(
        {"block_t": 512, "new_knob": 7}).block_t == 512


@pytest.mark.parametrize("n,c,s", [(1500, 16, 4), (2048, 16, 4),
                                   (2049, 100, 32), (1_000_000, 100, 32),
                                   (1, 1, 1)])
@pytest.mark.parametrize("placement,resolve,source", [
    ("batched", "fused", "device"), ("sharded", "torch", "host")])
def test_cache_key_is_repros(n, c, s, placement, resolve, source):
    """The same shape gives ``repro``'s key string (pow2 buckets: shapes
    within a factor of two share an entry, across it they do not)."""
    fields = dict(n_events=n, n_campaigns=c, n_scenarios=s,
                  platform="cpu", device_count=4, placement=placement,
                  resolve=resolve, source=source)
    assert tune.cache_key(space.ProblemShape(**fields)) == \
        j_tune.cache_key(j_tune.ProblemShape(**fields))
    mk = lambda m: space.ProblemShape(n_events=m, n_campaigns=16,
                                      n_scenarios=4)
    assert tune.cache_key(mk(1500)) == tune.cache_key(mk(2048))
    assert tune.cache_key(mk(2048)) != tune.cache_key(mk(2049))


def test_cache_files_load_in_either_package(tmp_path):
    """Either package's file is the other's: the same schema, entries and
    configs come back."""
    key = "cpu|d1|N2048|C16|S4|batched|fused|device"
    config = {"block_t": 256, "events_per_chunk": 1024,
              "scenarios_per_chunk": 2, "prefetch": True,
              "skip_retired": False}
    ours = tune.TuningCache.load(tmp_path / "ours.json")
    ours.put(key, config, us_tuned=5.0, hardware="cuda-h100")
    ours.save()
    theirs = j_tune.TuningCache.load(tmp_path / "ours.json")
    assert theirs.entries == ours.entries
    assert j_tune.candidate_from_config(theirs.get(key)["config"]) \
        .config() == config
    jc = j_tune.TuningCache.load(tmp_path / "theirs.json")
    jc.put(key, config, origin="cost_model", hardware="cpu")
    jc.save()
    back = tune.TuningCache.load(tmp_path / "theirs.json")
    assert back.entries == jc.entries
    assert tune.candidate_from_config(back.get(key)["config"]).config() \
        == config
    assert json.loads((tmp_path / "ours.json").read_text())["schema"] == \
        json.loads((tmp_path / "theirs.json").read_text())["schema"]
    assert tune.default_cache_path().name != \
        j_tune.default_cache_path().name


def test_cache_schema_mismatch_and_corruption_fall_back(tmp_path):
    versioned = tmp_path / "old.json"
    versioned.write_text(json.dumps(
        {"schema": 999, "entries": {"k": {"config": {"block_t": 1024}}}}))
    assert tune.TuningCache.load(versioned).entries == {}
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    assert tune.TuningCache.load(corrupt).entries == {}
    # resolution still answers: the cost model, no raise
    plan = tune.resolve_plan(_tuned_plan(), n_events=N_EVENTS,
                             n_campaigns=N_CAMPAIGNS, n_scenarios=4,
                             device="cpu",
                             cache=tune.TuningCache.load(corrupt))
    assert not ex.needs_tuning(plan)
    assert isinstance(plan.block_t, int)


def test_cached_winner_is_validated_against_exact_shape(tmp_path):
    """Buckets are coarser than shapes: an entry illegal at the exact size
    (3 does not divide S=4) falls back to the cost model; a legal one is
    taken."""
    plan = _tuned_plan()
    shape = _shape(plan)
    cache = tune.TuningCache.load(tmp_path / "c.json")
    cache.put(tune.cache_key(shape), {"scenarios_per_chunk": 3})
    bad = tune.resolve_plan(plan, n_events=N_EVENTS,
                            n_campaigns=N_CAMPAIGNS, n_scenarios=4,
                            device="cpu", cache=cache)
    assert bad.scenario_chunks is None or \
        bad.scenario_chunks.scenarios_per_chunk != 3
    cache.put(tune.cache_key(shape), {"scenarios_per_chunk": 2})
    good = tune.resolve_plan(plan, n_events=N_EVENTS,
                             n_campaigns=N_CAMPAIGNS, n_scenarios=4,
                             device="cpu", cache=cache)
    assert good.scenario_chunks.scenarios_per_chunk == 2
    assert good.tuned is False and isinstance(good.block_t, int)


# ---------------------------------------------------------------------------
# (b) the lattice and the cost model
# ---------------------------------------------------------------------------

def test_plan_block_t_validation():
    assert ex.SweepPlan(block_t="auto").block_t == "auto"
    for bad in (0, -128, "big", True):
        with pytest.raises(ValueError, match="block_t") as err:
            ex.SweepPlan(block_t=bad)
        with pytest.raises(ValueError) as j_err:
            j_ex.SweepPlan(block_t=bad)
        assert str(err.value) == str(j_err.value)


def test_hardware_specs():
    """The roofline's devices: the H100's data-sheet rates, and ``repro``'s
    CPU stand-in; no TPU entry."""
    assert set(HARDWARE) == {"cuda-h100", "cpu"}
    h100 = HardwareSpec.for_backend("cuda")
    assert h100.name == "cuda-h100" and h100.peak_flops == 67e12
    assert h100.hbm_bw == 3.35e12 and h100.h2d_bw == 64e9
    assert h100.ici_bw == 450e9
    assert HardwareSpec.for_backend("cpu") == HardwareSpec.for_backend("?")
    cpu, j_cpu = HARDWARE["cpu"], J_HARDWARE["cpu"]
    for f in ("peak_flops", "hbm_bw", "ici_bw", "h2d_bw", "dispatch_us"):
        assert getattr(cpu, f) == getattr(j_cpu, f)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_lattice_is_legal_deterministic_and_incumbent_first(device):
    """On the CPU and (limits injected) for the card: the incumbent first,
    no repeats, every candidate legal by the executor's own checks, the
    ranking deterministic and sorted."""
    plan = _tuned_plan()
    limits = {"fused": 64, "sweep_resolve": 64}
    shape = _shape(plan, s=8, device=device, limits=limits)
    assert shape.resolve == ("fused" if device == "cuda" else "torch")
    cands = tune.enumerate_candidates(plan, shape, limits=limits)
    assert cands[0] == tune.default_candidate(plan)
    assert len(cands) == len(set(cands)) > 1
    for c in cands:
        assert space.is_legal(c, plan, shape, limits=limits)
        if c.events_per_chunk is not None:
            ex.check_chunks(ex.ChunkSpec(c.events_per_chunk),
                            n_events=N_EVENTS, local_n=N_EVENTS)
        if c.scenarios_per_chunk is not None:
            ex.check_scenario_chunks(
                ex.ScenarioChunkSpec(c.scenarios_per_chunk),
                n_scenarios=8, local_s=8)
    r1 = tune.rank_candidates(plan, shape, limits=limits)
    r2 = tune.rank_candidates(plan, shape, limits=limits)
    assert [c for c, _ in r1] == [c for c, _ in r2]
    assert all(a[1].total <= b[1].total for a, b in zip(r1, r1[1:]))
    # skip_retired moves only where the CUDA fused round takes it
    assert {c.skip_retired for c in cands} == (
        {True, False} if device == "cuda" else {True})
    assert {c.block_t for c in cands} == {space.DEFAULT_BLOCK_T}


def test_pinned_knobs_are_never_overridden():
    plan = ex.SweepPlan(chunks=ex.ChunkSpec(512),
                        scenario_chunks=ex.ScenarioChunkSpec(2),
                        block_t=128, tuned=True)
    shape = _shape(plan)
    for c in tune.enumerate_candidates(plan, shape):
        resolved = c.apply(plan)
        assert resolved.chunks.events_per_chunk == 512
        assert resolved.scenario_chunks.scenarios_per_chunk == 2
        assert resolved.block_t == 128


def test_shared_memory_gate_with_injected_limits():
    """On CUDA the fused round's shared memory is a hard gate: C above
    ``limits["fused"]`` makes every fused candidate illegal whatever its
    scenario chunk (S does not enter the gate), and ``shape_for`` sends
    such a C to the any-C back-end, where the gate does not apply; the
    cost model prefers the one-launch round where C fits."""
    plan = _tuned_plan()
    shape = space.ProblemShape(n_events=4096, n_campaigns=1024,
                               n_scenarios=64, platform="cuda",
                               resolve="fused")
    tight, roomy = {"fused": 512}, {"fused": 1024}
    for spc in (None, 1, 8, 64):
        cand = space.Candidate(scenarios_per_chunk=spc)
        assert not space.is_legal(cand, plan, shape, limits=tight)
        if spc != 64:
            assert space.is_legal(cand, plan, shape, limits=roomy)
    legal = tune.enumerate_candidates(plan, shape, limits=roomy)
    assert all(space.is_legal(c, plan, shape, limits=roomy) for c in legal)
    assert tune.enumerate_candidates(plan, shape, limits=tight) == \
        [tune.default_candidate(plan)]
    ranked = tune.rank_candidates(plan, shape, limits=roomy)
    best = ranked[0][0]
    assert best.events_per_chunk is None and best.scenarios_per_chunk is None
    wide = _shape(plan, device="cuda", limits={"fused": 8,
                                               "sweep_resolve": 8})
    assert wide.resolve == ex.ANY_C_BACKEND
    assert {c.skip_retired for c in tune.enumerate_candidates(
        plan, wide, limits={"fused": 8})} == {True}


@pytest.mark.parametrize("plan_kw,j_kw", [
    (dict(), dict()),
    (dict(resolve="torch"), dict(resolve="jnp")),
    (dict(resolve="fused"), dict(resolve="fused")),
    (dict(chunks=ex.ChunkSpec(512, source="host")),
     dict(chunks=j_ex.ChunkSpec(512, source="host"))),
    (dict(scenario_chunks=2), dict(scenario_chunks=2)),
], ids=["auto", "torch", "fused", "host", "pinned"])
@pytest.mark.parametrize("s", [1, 4, 8, 32])
def test_cpu_ranking_is_repros(plan_kw, j_kw, s):
    """On the CPU the port's lattice, in cost order, is ``repro``'s, config
    for config (the port's ``"torch"`` where ``repro`` has ``"jnp"``), and
    so is its cache key but for that name."""
    plan = _tuned_plan(**plan_kw)
    j_plan = j_ex.SweepPlan(block_t="auto", tuned=True, **j_kw)
    shape = _shape(plan, s=s)
    j_shape = j_tune.shape_for(j_plan, n_events=N_EVENTS,
                               n_campaigns=N_CAMPAIGNS, n_scenarios=s)
    ours = [c.config() for c, _ in tune.rank_candidates(plan, shape)]
    theirs = [c.config() for c, _ in j_tune.rank_candidates(j_plan, j_shape)]
    assert ours == theirs
    assert tune.cache_key(shape) == j_tune.cache_key(j_shape).replace(
        "|jnp|", "|torch|")


def test_dryrun_terms_count_the_launches():
    """``dryrun_terms`` counts the concrete plan's work: more values bytes
    for a two-pass chunked fused round than for the one-launch round on
    the card, and ``None`` for host streams and multihost."""
    plan = _tuned_plan(resolve="fused")
    limits = {"fused": 64, "sweep_resolve": 64}
    shape = _shape(plan, device="cuda", limits=limits)
    one = space.dryrun_terms(space.Candidate(), plan, shape, limits=limits)
    chunked = space.dryrun_terms(space.Candidate(events_per_chunk=1024),
                                 plan, shape, limits=limits)
    assert chunked.bytes_per_device > one.bytes_per_device
    assert one.hardware == "cuda-h100"
    host = _shape(_tuned_plan(chunks=ex.ChunkSpec(512, source="host")))
    assert space.dryrun_terms(space.Candidate(), plan, host) is None


# ---------------------------------------------------------------------------
# (c) tuned == default, bit for bit
# ---------------------------------------------------------------------------

def _lanes(port, placement):
    values, _, grid = port
    if placement == "device":
        return values, grid.budgets[1], AuctionRule(
            multipliers=grid.rules.multipliers[1],
            reserve=grid.rules.reserve[1], kind=grid.rules.kind)
    return values, grid.budgets, grid.rules


@pytest.mark.parametrize("placement", ["device", "batched", "sharded"])
@pytest.mark.parametrize("resolve", ["torch", "sweep_resolve", "fused"])
def test_tuned_plan_is_bitwise_default(port, placement, resolve, tmp_path,
                                       monkeypatch):
    """Every output of a tuned plan is the default plan's, in each
    placement × back-end cell (sharded on four CPU shards): once resolved
    by the cost model, once through a cached winner that chunks events
    (and, batched, scenarios), read from the default cache file."""
    values, budgets, rules = _lanes(port, placement)
    mesh = SweepMeshSpec.for_devices(devices=["cpu"] * 4) \
        if placement == "sharded" else None
    base = ex.SweepPlan(placement=placement, resolve=resolve, mesh=mesh)
    tuned = dataclasses.replace(base, block_t="auto", tuned=True)
    want = ex.execute_sweep(values, budgets, rules, base)
    _same_outputs(ex.execute_sweep(values, budgets, rules, tuned), want,
                  f"{placement}/{resolve} cost model")
    s = budgets.shape[0] if budgets.ndim == 2 else 1
    shape = tune.shape_for(tuned, n_events=N_EVENTS,
                           n_campaigns=N_CAMPAIGNS, n_scenarios=s,
                           device="cpu")
    winner = space.Candidate(events_per_chunk=256,
                             scenarios_per_chunk=2 if s == 4 else None,
                             skip_retired=False)
    assert space.is_legal(winner, tuned, shape)
    path = tmp_path / "winner.json"
    cache = tune.TuningCache.load(path)
    cache.put(tune.cache_key(shape), winner.config())
    cache.save()
    monkeypatch.setenv(tune.ENV_VAR, str(path))
    assert tune.resolve_plan(tuned, n_events=N_EVENTS,
                             n_campaigns=N_CAMPAIGNS, n_scenarios=s,
                             device="cpu") == winner.apply(tuned)
    _same_outputs(ex.execute_sweep(values, budgets, rules, tuned), want,
                  f"{placement}/{resolve} cached winner")


def test_tuned_plan_bitwise_through_measured_cache(port, tmp_path):
    """autotune measures (a tiny budget), keeps a winner, and a later
    tuned sweep resolves through that entry to the default plan's bits."""
    values, _, grid = port
    plan = _tuned_plan()
    report = tune.autotune(values, grid.budgets, grid.rules, plan,
                           trials=2, quick_trials=1, top_k=2,
                           max_events=512, cache_path=tmp_path / "m.json")
    assert report.origin == "measured"
    assert report.n_candidates > 1 and report.measured_events == 512
    assert report.measurements and all(
        m.us > 0 and m.us_default > 0 for m in report.measurements)
    cache = tune.TuningCache.load(report.cache_path)
    assert cache.get(report.key)["config"] == report.winner_config
    resolved = tune.resolve_plan(plan, n_events=N_EVENTS,
                                 n_campaigns=N_CAMPAIGNS,
                                 n_scenarios=grid.budgets.shape[0],
                                 device="cpu", cache=cache)
    assert resolved == report.plan(plan)
    _same_outputs(
        ex.execute_sweep(values, grid.budgets, grid.rules, resolved),
        ex.execute_sweep(values, grid.budgets, grid.rules, ex.SweepPlan()),
        "measured winner")


@pytest.mark.parametrize("driver", ["batched", "sharded"])
def test_engine_tune_then_tuned_sweep(port, tmp_path, monkeypatch, driver):
    """engine.tune() fills the cache; engine.sweep(tuned=True) and
    block_t="auto" serve through it, bitwise the untuned sweep (and, on
    four CPU shards, the one-device sweep)."""
    values, budgets, grid = port
    cache_path = tmp_path / "engine.json"
    monkeypatch.setenv(tune.ENV_VAR, str(cache_path))
    mesh = SweepMeshSpec.for_devices(devices=["cpu"] * 4) \
        if driver == "sharded" else None
    engine = CounterfactualEngine(values, budgets, device="cpu")
    report = engine.tune(driver=driver, mesh=mesh, trials=2, quick_trials=1,
                         top_k=2, max_events=1024, cache_path=cache_path)
    assert report.origin == "measured"
    assert report.speedup is None or report.speedup >= 1.0
    assert cache_path.exists()
    ref = engine.sweep(grid)
    for kw in (dict(tuned=True), dict(block_t="auto")):
        out = engine.sweep(grid, driver=driver, mesh=mesh, **kw)
        assert torch.equal(out.results.final_spend, ref.results.final_spend)
        assert torch.equal(out.results.cap_times, ref.results.cap_times)


def test_service_tuned_passthrough_and_tune(env, port, tmp_path):
    """A tuned=True service answers bitwise an untuned one; tune() pins the
    measured winner without changing an answer; a host store's tune()
    raises ``repro``'s text."""
    from repro.serve import CounterfactualService as JService
    from repro_torch.serve import CounterfactualService
    values, budgets, _ = port
    base = AuctionRule.first_price(N_CAMPAIGNS, device="cpu")
    ref = CounterfactualService(budgets, base, events_per_chunk=256,
                                device="cpu")
    ref.append(values)
    want = ref.ask().result()
    svc = CounterfactualService(budgets, base, events_per_chunk=256,
                                tuned=True, device="cpu")
    svc.append(values)
    got = svc.ask().result()
    assert torch.equal(got.final_spend, want.final_spend)
    assert torch.equal(got.cap_times, want.cap_times)
    report = svc.tune(scenarios=2, trials=2, quick_trials=1, top_k=2,
                      max_events=512, cache_path=tmp_path / "svc.json")
    assert not ex.needs_tuning(svc.plan)
    assert svc.plan == report.plan(ex.SweepPlan(block_t="auto", tuned=True))
    got2 = svc.ask(budgets=budgets * 0.5).result()
    want2 = ref.ask(budgets=budgets * 0.5).result()
    assert torch.equal(got2.final_spend, want2.final_spend)
    assert torch.equal(got2.cap_times, want2.cap_times)
    host = CounterfactualService(budgets, base, events_per_chunk=256,
                                 store="host", device="cpu")
    host.append(values)
    with pytest.raises(ValueError, match="tuned=True") as err:
        host.tune()
    j_host = JService(env.budgets, events_per_chunk=256, store="host")
    j_host.append(np.asarray(env.values))
    with pytest.raises(ValueError) as j_err:
        j_host.tune()
    assert str(err.value) == str(j_err.value)


def test_service_load_takes_tuned(port, tmp_path):
    """``CounterfactualService.load(..., tuned=True)`` restores a service
    whose replay plan is the tuner's, answering with the saved one's
    bits."""
    from repro_torch.serve import CounterfactualService
    values, budgets, _ = port
    base = AuctionRule.first_price(N_CAMPAIGNS, device="cpu")
    svc = CounterfactualService(budgets, base, events_per_chunk=256,
                                device="cpu")
    svc.append(values)
    want = svc.ask().result()
    svc.save(tmp_path / "ckpt")
    back = CounterfactualService.load(tmp_path / "ckpt", tuned=True,
                                      device="cpu")
    assert back.plan.tuned and back.plan.block_t == "auto"
    got = back.ask().result()
    assert torch.equal(got.final_spend, want.final_spend)
    assert torch.equal(got.cap_times, want.cap_times)


def test_resumable_and_s2a_normalise_tuned_plans(port):
    """Fold windows and the SORT2AGGREGATE spine run a tuned plan at the
    defaults (the tuner models whole parallel sweeps): the same bits."""
    values, _, grid = port
    s = grid.budgets.shape[0]
    out, _ = ex.execute_sweep_resumable(
        values, grid.budgets, grid.rules, _tuned_plan(),
        carry=ex.initial_carry(s, N_CAMPAIGNS, device="cpu"))
    ref, _ = ex.execute_sweep_resumable(
        values, grid.budgets, grid.rules, ex.SweepPlan(),
        carry=ex.initial_carry(s, N_CAMPAIGNS, device="cpu"))
    _same_outputs(out, ref, "resumable")
    got = ex.execute_s2a_sweep(values, grid.budgets, grid.rules,
                               _tuned_plan(), refine_iters=2)
    want = ex.execute_s2a_sweep(values, grid.budgets, grid.rules,
                                ex.SweepPlan(), refine_iters=2)
    assert torch.equal(got[0].final_spend, want[0].final_spend)
    assert torch.equal(got[0].cap_times, want[0].cap_times)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
