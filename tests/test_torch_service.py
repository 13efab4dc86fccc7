"""The port's always-on counterfactual service against ``repro``'s, at
``tests/test_service.py``'s size (N=512, C=8, appends in chunks of 128,
its three partitions), on the same inputs: every exact answer (asks, grid
and family sweeps, a bound engine's sweep and search, cache hits),
streaming frontier, host-store answer and save/load cycle of the port is
bitwise ``repro``'s, its counters are ``repro``'s, and its errors carry
``repro``'s texts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.scenarios import BidNoise as JBidNoise  # noqa: E402
from repro.scenarios import PauseCampaign as JPause  # noqa: E402
from repro.scenarios import ScaleBudget as JScaleBudget  # noqa: E402
from repro.scenarios import compile_family as j_compile  # noqa: E402
from repro.search import SearchSpace as JSpace  # noqa: E402
from repro.serve import CounterfactualService as JService  # noqa: E402
from repro_torch.core import AuctionRule, ScenarioGrid  # noqa: E402
from repro_torch.core.executor import HostStream  # noqa: E402
from repro_torch.interop import from_reference, key_from_reference  # noqa: E402,E501
from repro_torch.scenarios import (AddEntrant, BidNoise,  # noqa: E402
                                   PauseCampaign, ScaleBudget,
                                   compile_family)
from repro_torch.search import SearchSpace  # noqa: E402
from repro_torch.serve import CounterfactualService  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_N, _C = 512, 8
_EPC = 128
PARTITIONS = [(_N,), (128, 384), (128, 128, 128, 128)]
IDS = ["one", "uneven", "quarters"]


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(2), n_events=_N,
                              n_campaigns=_C, emb_dim=6)


@pytest.fixture(scope="module")
def grid(env):
    base = JRule.first_price(_C)
    rules = [base, base.with_multiplier(2, 1.7), base.with_multiplier(5, 0.4),
             JRule(multipliers=jnp.full((_C,), 1.2, jnp.float32),
                   reserve=jnp.asarray(0.05, jnp.float32),
                   kind="first_price")]
    budgets = [env.budgets, env.budgets * 0.7, env.budgets * 1.3,
               env.budgets]
    return JGrid.from_scenarios(list(zip(rules, budgets)))


@pytest.fixture(scope="module")
def port(env, grid):
    """The port's values, base budgets, base rule and grid."""
    values, port_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device="cpu")
    budgets = torch.from_numpy(np.array(env.budgets))
    return values, budgets, AuctionRule.first_price(_C, device="cpu"), \
        port_grid


@pytest.fixture(scope="module")
def reference(env, grid):
    return JEngine(env.values, env.budgets, JRule.first_price(_C)).sweep(
        grid, method="parallel")


def _splits(values, partition):
    out, start = [], 0
    for n in partition:
        out.append(values[start:start + n])
        start += n
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(want, got):
    want, got = np.asarray(want), _np(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(got, want)


def _assert_sweep(want, got):
    _same(want.results.final_spend, got.results.final_spend)
    _same(want.results.cap_times, got.results.cap_times)
    assert want.n_events == got.n_events
    assert want.base_index == got.base_index


def _assert_answer(want, got):
    _same(want.final_spend, got.final_spend)
    _same(want.cap_times, got.cap_times)
    assert want.log_version == got.log_version


def _service(port, **kwargs):
    _, budgets, base, _ = port
    return CounterfactualService(budgets, base, events_per_chunk=_EPC,
                                 device="cpu", **kwargs)


def _rule(rule: JRule) -> AuctionRule:
    return AuctionRule(multipliers=torch.from_numpy(np.array(
        rule.multipliers)), reserve=torch.from_numpy(np.array(
            rule.reserve)), kind=rule.kind)


def _scenario(grid, s):
    rule, budgets = grid.scenario(s)
    return _rule(rule), torch.from_numpy(np.array(budgets))


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


# ---------------------------------------------------------------------------
# appends: the exact path is repro's one-shot sweep, across plan cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partition", PARTITIONS, ids=IDS)
@pytest.mark.parametrize("plan_kwargs", [
    dict(), dict(resolve="fused"), dict(resolve="sweep_resolve"),
    dict(scenario_chunks=2), dict(chunks=128),
], ids=["default", "fused", "sweep_resolve", "schunk2", "echunk128"])
def test_incremental_append_is_repros(port, reference, partition,
                                      plan_kwargs):
    values, _, _, port_grid = port
    svc = _service(port, **plan_kwargs)
    for slab in _splits(values, partition):
        svc.append(slab)
    _assert_sweep(reference, svc.sweep(port_grid))


def test_mid_stream_sweeps_are_repros(env, grid, port):
    values, _, _, port_grid = port
    svc = _service(port)
    start = 0
    for n in (128, 256, 128):
        svc.append(values[start:start + n])
        start += n
        want = JEngine(env.values[:start], env.budgets,
                       JRule.first_price(_C)).sweep(grid)
        _assert_sweep(want, svc.sweep(port_grid))


# ---------------------------------------------------------------------------
# the cache and the admission batch: repro's answers and counters
# ---------------------------------------------------------------------------

def _both(env, port, **kwargs):
    values = port[0]
    want = JService(env.budgets, JRule.first_price(_C), events=env.values,
                    events_per_chunk=_EPC, **kwargs)
    got = _service(port, events=values, **kwargs)
    return want, got


def test_cache_hits_and_counters_are_repros(env, grid, port, reference):
    want, got = _both(env, port)
    port_grid = port[3]
    first = got.sweep(port_grid)
    want.sweep(grid)
    assert got.stats == want.stats
    second = got.sweep(port_grid)
    want.sweep(grid)
    assert got.stats == want.stats and got.stats["batches"] == 1
    _assert_sweep(reference, first)
    _assert_sweep(reference, second)


def test_append_drops_the_cache(env, grid, port):
    values, _, _, port_grid = port
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    got = _service(port)
    for svc, vals, g in ((want, env.values, grid), (got, values, port_grid)):
        svc.append(vals[:256])
        svc.sweep(g)
        svc.append(vals[256:])
        assert svc.stats["cached"] == 0
    _assert_sweep(want.sweep(grid), got.sweep(port_grid))
    assert got.stats == want.stats


def test_overlapping_grids_run_only_new_lanes(env, grid, port):
    want, got = _both(env, port)
    port_grid = port[3]
    base, pbase = JRule.first_price(_C), port[2]
    shifted = JGrid.from_scenarios([grid.scenario(1), grid.scenario(2),
                                    (base.with_multiplier(0, 2.5),
                                     env.budgets)])
    p_shifted = ScenarioGrid.from_scenarios(
        [_scenario(grid, 1), _scenario(grid, 2),
         (pbase.with_multiplier(0, 2.5), port[1])])
    want.sweep(grid)
    got.sweep(port_grid)
    _assert_sweep(want.sweep(shifted), got.sweep(p_shifted))
    assert got.stats == want.stats
    assert got.stats["hits"] == 2 and got.stats["misses"] == 5


def test_admission_batch_is_repros(env, grid, port):
    want, got = _both(env, port)
    w_tickets = [want.ask(*grid.scenario(s), label=f"s{s}")
                 for s in range(4)]
    g_tickets = [got.ask(*_scenario(grid, s), label=f"s{s}")
                 for s in range(4)]
    assert not any(t.done for t in g_tickets)
    assert [t.fingerprint for t in g_tickets] == \
        [t.fingerprint for t in w_tickets]
    for w, g in zip(w_tickets, g_tickets):
        _assert_answer(w.result(), g.result())
        assert g.label == w.label and g.seq == w.seq
    assert got.stats == want.stats and got.stats["batches"] == 1


def test_admission_order_changes_no_answer(env, grid, port):
    answers = []
    for order in ([0, 1, 2, 3], [3, 2, 1, 0]):
        svc = _service(port, events=port[0])
        tickets = {s: svc.ask(*_scenario(grid, s)) for s in order}
        svc.flush()
        answers.append({s: tickets[s].result() for s in order})
    want = JService(env.budgets, JRule.first_price(_C), events=env.values,
                    events_per_chunk=_EPC)
    for s in range(4):
        serial = want.ask(*grid.scenario(s)).result()
        for got in answers:
            _assert_answer(serial, got[s])


def test_oversized_batch_is_scenario_chunked(env, grid, port):
    want, got = _both(env, port, max_batch=3)
    w_t = [want.ask(*grid.scenario(s)) for s in range(4)]
    w_t += [want.ask(budgets=env.budgets * (0.5 + 0.1 * i))
            for i in range(4)]
    g_t = [got.ask(*_scenario(grid, s)) for s in range(4)]
    g_t += [got.ask(budgets=port[1] * np.float32(0.5 + 0.1 * i))
            for i in range(4)]
    for w, g in zip(w_t, g_t):
        _assert_answer(w.result(), g.result())
    assert got.stats == want.stats and got.stats["batches"] == 1


def test_duplicate_asks_count_hits_not_lanes(env, port):
    want, got = _both(env, port)
    for svc in (want, got):
        a, b = svc.ask(), svc.ask()
        a.result(), b.result()
        svc.ask().result()
    assert got.stats == want.stats
    assert got.stats["hits"] == 2 and got.stats["batches"] == 1


def test_append_answers_pending_asks_first(env, port):
    values = port[0]
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    got = _service(port)
    want.append(env.values[:256])
    got.append(values[:256])
    w, g = want.ask(), got.ask()
    want.append(env.values[256:])
    got.append(values[256:])
    assert g.done and g.result().log_version == 1
    _assert_answer(w.result(), g.result())


# ---------------------------------------------------------------------------
# a service-bound engine
# ---------------------------------------------------------------------------

def test_bound_engine_sweeps_through_the_service(env, grid, port,
                                                 reference):
    want, got = _both(env, port)
    bound = got.engine()
    assert bound.service is got
    _assert_sweep(reference, bound.sweep(port[3], method="parallel"))
    batches = got.stats["batches"]
    _assert_sweep(reference, bound.sweep(port[3]))
    assert got.stats["batches"] == batches
    seq = bound.sweep(port[3], method="sequential")
    _assert_sweep(want.engine().sweep(grid, method="sequential"), seq)
    assert got.stats["batches"] == batches


def test_search_through_the_service_is_repros(env, port):
    want, got = _both(env, port)
    j_space = JSpace(bid_scale=(0.6, 1.6), reserve=(0.0, 0.2))
    space = SearchSpace(bid_scale=(0.6, 1.6), reserve=(0.0, 0.2))
    a = want.engine().search(j_space, budget=64)
    b = got.engine().search(space, budget=64)
    assert b.best_point == a.best_point
    assert b.best_value == a.best_value
    assert b.evaluations == a.evaluations
    assert got.stats == want.stats and got.stats["batches"] > 0


def test_stale_engine_raises_repros_text(env, grid, port):
    values, _, _, port_grid = port
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    got = _service(port)
    want.append(env.values[:256])
    got.append(values[:256])
    w_bound, g_bound = want.engine(), got.engine()
    want.append(env.values[256:])
    got.append(values[256:])
    assert _message(lambda: g_bound.sweep(port_grid)) == \
        _message(lambda: w_bound.sweep(grid))
    _assert_sweep(want.engine().sweep(grid), got.engine().sweep(port_grid))


# ---------------------------------------------------------------------------
# scenario families through the service
# ---------------------------------------------------------------------------

def test_family_sweeps_are_repros(env, port):
    values, budgets, base, _ = port
    j_fam = j_compile(env.values, env.budgets, JRule.first_price(_C),
                      [[JPause(2)], [JScaleBudget(1, 0.5)]])
    fam = compile_family(values, budgets, base,
                         [[PauseCampaign(2)], [ScaleBudget(1, 0.5)]])
    assert fam.fingerprints() == j_fam.fingerprints()
    want, got = _both(env, port)
    _assert_sweep(want.sweep(j_fam), got.sweep(fam))
    batches = got.stats["batches"]
    _assert_sweep(want.engine().sweep(j_fam), got.engine().sweep(fam))
    assert got.stats == want.stats and got.stats["batches"] == batches


def test_overlay_family_sweep_is_repros(env, port):
    values, budgets, base, _ = port
    key = jax.random.PRNGKey(7)
    j_fam = j_compile(env.values, env.budgets, JRule.first_price(_C),
                      [[JBidNoise(0.1)], [JPause(0)]], key=key)
    fam = compile_family(values, budgets, base,
                         [[BidNoise(0.1)], [PauseCampaign(0)]],
                         key=key_from_reference(np.asarray(key)))
    want, got = _both(env, port)
    _assert_sweep(want.sweep(j_fam), got.sweep(fam))


def test_family_errors_are_repros(env, port):
    values, budgets, base, _ = port
    want, got = _both(env, port)
    from repro.scenarios import AddEntrant as JAddEntrant
    key = jax.random.PRNGKey(9)
    entrant = compile_family(values, budgets, base,
                             [[AddEntrant(budget=5.0, value_scale=0.8)]],
                             key=key_from_reference(np.asarray(key)))
    j_entrant = j_compile(env.values, env.budgets, JRule.first_price(_C),
                          [[JAddEntrant(budget=5.0, value_scale=0.8)]],
                          key=key)
    assert _message(lambda: got.sweep(entrant)) == \
        _message(lambda: want.sweep(j_entrant))
    stale = compile_family(values[:256], budgets, base, [[PauseCampaign(2)]])
    j_stale = j_compile(env.values[:256], env.budgets,
                        JRule.first_price(_C), [[JPause(2)]])
    assert _message(lambda: got.sweep(stale)) == \
        _message(lambda: want.sweep(j_stale))


# ---------------------------------------------------------------------------
# streaming carries
# ---------------------------------------------------------------------------

def _streams(svc, grid, port_side):
    for s in range(4):
        svc.register(f"s{s}", *(_scenario(grid, s) if port_side
                                else grid.scenario(s)))


@pytest.mark.parametrize("partition", PARTITIONS, ids=IDS)
def test_streaming_frontiers_are_repros(env, grid, port, reference,
                                        partition):
    """Four lanes registered before the appends: the causal frontier after
    every partition is ``repro``'s; after one append it is the one-shot
    sweep."""
    values = port[0]
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    got = _service(port)
    _streams(want, grid, False)
    _streams(got, grid, True)
    for w_slab, g_slab in zip(_splits(env.values, partition),
                              _splits(values, partition)):
        want.append(w_slab)
        got.append(g_slab)
    for s in range(4):
        _assert_answer(want.streaming(f"s{s}"), got.streaming(f"s{s}"))
        if len(partition) == 1:
            _same(np.asarray(reference.results.final_spend)[s],
                  got.streaming(f"s{s}").final_spend)


def test_registering_mid_log_catches_up(env, port):
    values, _, base, _ = port
    rule = base.with_multiplier(3, 1.4)
    got = []
    for register_at in (0, 1, 2):
        svc = _service(port)
        for i, slab in enumerate(_splits(values, (256, 256))):
            if i == register_at:
                svc.register("x", rule)
            svc.append(slab)
        if register_at == 2:
            svc.register("x", rule)
        got.append(svc.streaming("x"))
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    want.register("x", JRule.first_price(_C).with_multiplier(3, 1.4))
    for slab in _splits(env.values, (256, 256)):
        want.append(slab)
    for g in got:
        _assert_answer(want.streaming("x"), g)


def test_stream_label_errors_are_repros(env, port):
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    got = _service(port)
    want.register("x")
    got.register("x")
    assert _message(lambda: got.register("x")) == \
        _message(lambda: want.register("x"))
    assert _message(lambda: got.streaming("y")) == \
        _message(lambda: want.streaming("y"))


# ---------------------------------------------------------------------------
# the host store and checkpoints
# ---------------------------------------------------------------------------

def _with_streams(svc, base, partition, values):
    svc.register("base")
    svc.register("hot2", rule=base.with_multiplier(2, 1.7))
    for slab in _splits(values, partition):
        svc.append(slab)
    return svc


@pytest.mark.parametrize("partition", PARTITIONS, ids=IDS)
def test_host_store_is_repros(env, grid, port, reference, partition):
    """``store="host"`` (the 'uneven' partition's second fold has no
    aligned host chunking and is folded on the device, as in ``repro``):
    exact and streaming answers bitwise ``repro``'s host store and the
    port's device store."""
    values, _, base, port_grid = port
    want = _with_streams(
        JService(env.budgets, JRule.first_price(_C), events_per_chunk=_EPC,
                 store="host"), JRule.first_price(_C), partition, env.values)
    got = _with_streams(_service(port, store="host"), base, partition,
                        values)
    dev = _with_streams(_service(port), base, partition, values)
    _assert_sweep(reference, got.sweep(port_grid))
    for label in ("base", "hot2"):
        _assert_answer(want.streaming(label), got.streaming(label))
        _assert_answer(dev.streaming(label), got.streaming(label))
    _assert_answer(want.ask().result(), got.ask().result())
    assert isinstance(got.values, HostStream)
    assert len(got.values._slabs) == len(partition)


def test_host_store_validation_is_repros(env, port):
    from repro.launch.mesh import SweepMeshSpec
    values, budgets, base, _ = port
    cases = [
        (dict(store="disk"), dict(store="disk")),
        (dict(store="host", placement="sharded",
              mesh=SweepMeshSpec.for_devices()),
         dict(store="host", placement="sharded", mesh=object())),
        (dict(store="host", scenario_chunks=2),
         dict(store="host", scenario_chunks=2)),
        (dict(store="host", events_per_chunk=48),
         dict(store="host", events_per_chunk=48)),
    ]
    for j_kw, kw in cases:
        assert _message(lambda: CounterfactualService(
            budgets, base, device="cpu", **kw)) == \
            _message(lambda: JService(env.budgets, JRule.first_price(_C),
                                      **j_kw))


@pytest.mark.parametrize("store", ["device", "host"])
def test_save_load_append_cycle_is_repros(env, grid, port, store,
                                          tmp_path):
    """Saved after (128, 256), restored, the last 128 appended: streaming,
    grid and ask answers bitwise ``repro``'s uninterrupted service."""
    values, _, base, port_grid = port
    want = _with_streams(
        JService(env.budgets, JRule.first_price(_C), events_per_chunk=_EPC,
                 store=store), JRule.first_price(_C), (128, 256),
        env.values[:384])
    svc = _with_streams(_service(port, store=store), base, (128, 256),
                        values[:384])
    ckpt_dir = svc.save(tmp_path)
    assert ckpt_dir.name == f"step_{svc.log_version:08d}"
    restored = CounterfactualService.load(tmp_path, device="cpu")
    assert restored.store == store
    assert restored.log_version == svc.log_version == 2
    assert restored.stats["registered"] == 2
    want.append(env.values[384:])
    restored.append(values[384:])
    for label in ("base", "hot2"):
        _assert_answer(want.streaming(label), restored.streaming(label))
    _assert_sweep(want.sweep(grid), restored.sweep(port_grid))
    j_rule = JRule.first_price(_C).with_multiplier(5, 0.4)
    _assert_answer(want.ask(rule=j_rule).result(),
                   restored.ask(rule=base.with_multiplier(5, 0.4)).result())


def test_load_without_checkpoints_raises(tmp_path):
    assert _message(lambda: CounterfactualService.load(tmp_path,
                                                       device="cpu"),
                    FileNotFoundError) == \
        _message(lambda: JService.load(tmp_path), FileNotFoundError)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_input_errors_are_repros(env, port):
    values, budgets, base, _ = port
    want = JService(env.budgets, JRule.first_price(_C),
                    events_per_chunk=_EPC)
    got = _service(port)
    pairs = [
        (lambda: got.ask().result(), lambda: want.ask().result()),
        (lambda: got.append(values[:, :4]),
         lambda: want.append(env.values[:, :4])),
        (lambda: got.append(values[:0]), lambda: want.append(env.values[:0])),
        (lambda: got.append(values[:100]),
         lambda: want.append(env.values[:100])),
        (lambda: got.ask(budgets=budgets[:4]),
         lambda: want.ask(budgets=env.budgets[:4])),
        (lambda: CounterfactualService(budgets[None, :], base, device="cpu"),
         lambda: JService(env.budgets[None, :], JRule.first_price(_C))),
        (lambda: CounterfactualService(budgets, base, max_batch=0,
                                       device="cpu"),
         lambda: JService(env.budgets, JRule.first_price(_C), max_batch=0)),
    ]
    for ours, theirs in pairs:
        assert _message(ours) == _message(theirs)


def test_unported_options_raise(env, grid, port, reference, tmp_path):
    """The mesh options run (the name is the item-8 test's): a service
    with ``placement="sharded"`` on four CPU shards, and on a 2 × 2 mesh
    (three asks padded to whole scenario groups), answers its asks and its
    sweep bitwise ``repro``'s one-shot sweep; a sharded placement without a
    mesh and a host store with a mesh raise ``repro``'s texts.
    ``tuned=True`` runs too (tuning): its asks are bitwise ``repro``'s
    sweep, ``tune()`` pins a concrete plan, and a host store's ``tune()``
    raises ``repro``'s text."""
    from repro_torch.launch.mesh import SweepMeshSpec
    values, budgets, base, port_grid = port
    for shape in ((4,), (2, 2)):
        mesh = SweepMeshSpec.for_devices(*shape, devices=["cpu"] * 4)
        svc = _service(port, placement="sharded", mesh=mesh)
        svc.append(values)
        tickets = [svc.ask(*_scenario(grid, s)) for s in range(3)]
        for s, ticket in enumerate(tickets):
            got = ticket.result()
            _same(reference.results.final_spend[s], got.final_spend)
            _same(reference.results.cap_times[s], got.cap_times)
        _assert_sweep(reference, svc.sweep(port_grid))
    want = _message(lambda: JService(env.budgets, JRule.first_price(_C),
                                     placement="sharded"))
    assert _message(lambda: _service(port, placement="sharded")) == \
        want.replace("repro.launch", "repro_torch.launch")
    assert _message(lambda: _service(port, store="host", mesh=mesh)) == \
        _message(lambda: JService(env.budgets, JRule.first_price(_C),
                                  store="host", mesh=object()))
    from repro_torch.core.executor import needs_tuning
    tuned = _service(port, tuned=True)
    assert tuned.plan.tuned and tuned.plan.block_t == "auto"
    tuned.append(values)
    for s in range(3):
        got = tuned.ask(*_scenario(grid, s)).result()
        _same(reference.results.final_spend[s], got.final_spend)
        _same(reference.results.cap_times[s], got.cap_times)
    tuned.tune(scenarios=2, trials=1, quick_trials=1, top_k=2,
               max_events=256, cache_path=tmp_path / "svc.json")
    assert not needs_tuning(tuned.plan)
    _assert_sweep(reference, tuned.sweep(port_grid))
    assert "store='host' replans" in _message(
        lambda: _service(port, store="host").tune())
