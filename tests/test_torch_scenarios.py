"""CRN scenario families in the port against ``repro`` on the same inputs
(``repro.data.make_synthetic_env``, N=512, C=8, as tests/test_scenarios.py
uses), bit for bit: every intervention's compiled arrays, the fingerprints
string for string, family sweeps (static and per-event overlays) on every
back-end the CPU has with event chunks, scenario chunks and
``placement="device"``, Algorithm 4 with an overlay, the kernel's CPU
mirror with a mask, the attribution goldens and the CRN metamorphic
properties of tests/test_scenarios.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as jsc  # noqa: E402
from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core import vi as jvi  # noqa: E402
from repro.core.types import ScenarioOverlay as JOverlay  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch import scenarios as sc  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              SweepPlan, execute_sweep, executor,
                              sweep_parallel, vi)
from repro_torch.core.types import ScenarioOverlay  # noqa: E402
from repro_torch.interop import (family_from_reference,  # noqa: E402
                                 key_from_reference, overlay_from_reference)
from repro_torch.kernels.auction_resolve import ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _partitionable():
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", before)


N, C = 512, 8
FAMILY_KEY = 5


@functools.lru_cache(maxsize=1)
def _env():
    return make_synthetic_env(jax.random.PRNGKey(3), n_events=N,
                              n_campaigns=C, emb_dim=6)


@functools.lru_cache(maxsize=1)
def _engines():
    env = _env()
    j = JEngine(env.values, env.budgets, JRule.first_price(C))
    p = CounterfactualEngine(np.array(env.values), np.array(env.budgets),
                             AuctionRule.first_price(C, device="cpu"),
                             device="cpu")
    return j, p


def _pkey(seed):
    return key_from_reference(np.asarray(jax.random.PRNGKey(seed)))


# each entry: the scenario specs of one family (repro's intervention
# classes; the port's have the same names and fields)
def _specs(m):
    return {
        "static": [(m.PauseCampaign(3),), (m.BoostCampaign(1, 1.7),),
                   (m.PauseCampaign(0), m.SetReserve(0.05)),
                   (m.ScaleBudget(2, 0.5), m.ScaleBids(1.1))],
        "pacing": [(m.BoostCampaign(1, 1.7),
                    m.BudgetPacing(4, start=128, stop=384)),
                   (m.BudgetPacing(0, start=65, stop=257),
                    m.PauseCampaign(6))],
        "noise": [(m.BidNoise(0.3), m.ParticipationJitter(0.8, campaign=2)),
                  (m.BudgetPacing(0, start=65, stop=257),
                   m.BidNoise(0.2, campaign=5), m.PauseCampaign(6)),
                  (m.BidNoise(0.0), m.ParticipationJitter(1.0))],
        "entrant": [(m.AddEntrant(budget=2.0, multiplier=1.2,
                                  value_scale=.8),),
                    (m.AddEntrant(budget=1.0, start=0, stop=None,
                                  slot="b"), m.PauseCampaign(1)),
                    (m.AddEntrant(budget=1.5, slot="c", values=np.linspace(
                        0, 1, N, dtype=np.float32)),)],
        "design": [(m.BoostCampaign(1, 1.5),),
                   {"bid_scale": 1.2, "budget_scale": 0.5, "boost[3]": 2.0,
                    "reserve": 0.01},
                   (m.MultiplierJitter(0.3, draw=1),),
                   (m.MultiplierJitter(0.2, draw=2, campaign=3),
                    m.ScaleBudgets(0.7))],
    }


FAMILIES = ("static", "pacing", "noise", "entrant", "design")


@functools.lru_cache(maxsize=None)
def _families(name):
    j, p = _engines()
    jfam = jsc.compile_family(j.values, j.budgets, j.base_rule,
                              _specs(jsc)[name],
                              key=jax.random.PRNGKey(FAMILY_KEY))
    pfam = sc.compile_family(p.values, p.budgets, p.base_rule,
                             _specs(sc)[name], key=_pkey(FAMILY_KEY))
    return jfam, pfam


@functools.lru_cache(maxsize=None)
def _reference_sweep(name, chunks=None, scenario_chunks=None):
    j, _ = _engines()
    out = j.sweep(_families(name)[0], resolve="jnp", chunks=chunks,
                  scenario_chunks=scenario_chunks)
    return (np.asarray(out.results.final_spend),
            np.asarray(out.results.cap_times))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    np.testing.assert_array_equal(got, want)


def _same_overlay(jol, pol):
    assert (jol is None) == (pol is None)
    if jol is None:
        return
    for name in ScenarioOverlay.FIELDS:
        a, b = getattr(jol, name), getattr(pol, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _same(a, b)
            assert b.dtype == (torch.int32 if name.startswith("live")
                               else torch.float32)
    assert jol.time_varying == pol.time_varying
    assert (jol.key is None) == (pol.key is None)
    if jol.key is not None:
        _same(np.asarray(jol.key).astype(np.int64), pol.key)


# ---------------------------------------------------------------------------
# compilation and fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_compiled_family_is_the_reference(name):
    jfam, pfam = _families(name)
    _same(jfam.values, pfam.values)
    _same(jfam.grid.rules.multipliers, pfam.grid.rules.multipliers)
    _same(jfam.grid.rules.reserve, pfam.grid.rules.reserve)
    _same(jfam.grid.budgets, pfam.grid.budgets)
    assert jfam.grid.rules.kind == pfam.grid.rules.kind
    assert jfam.labels == pfam.labels
    assert jfam.entrant_slots == pfam.entrant_slots
    assert jfam.num_entrants == pfam.num_entrants
    _same_overlay(jfam.overlay, pfam.overlay)


@pytest.mark.parametrize("name", FAMILIES)
def test_fingerprints_are_the_reference(name):
    jfam, pfam = _families(name)
    assert pfam.fingerprints() == jfam.fingerprints()
    assert pfam.fingerprint() == jfam.fingerprint()
    assert sc.grid_fingerprints(pfam.grid, pfam.overlay) == \
        jsc.grid_fingerprints(jfam.grid, jfam.overlay)
    mult = np.asarray(jfam.grid.rules.multipliers)[0]
    assert sc.design_fingerprint(
        kind="first_price", multipliers=pfam.grid.rules.multipliers[0],
        reserve=pfam.grid.rules.reserve[0], budgets=pfam.grid.budgets[0],
        extra=b"x") == jsc.design_fingerprint(
        kind="first_price", multipliers=mult,
        reserve=np.asarray(jfam.grid.rules.reserve)[0],
        budgets=np.asarray(jfam.grid.budgets)[0], extra=b"x")


def test_family_contract_errors_are_the_reference():
    _, p = _engines()
    with pytest.raises(ValueError, match="pass key= to compile_family"):
        sc.compile_family(p.values, p.budgets, p.base_rule,
                          [sc.BidNoise(0.2)])
    with pytest.raises(ValueError, match="out of range"):
        sc.compile_family(p.values, p.budgets, p.base_rule,
                          [sc.PauseCampaign(C)])
    with pytest.raises(ValueError, match="invalid"):
        sc.compile_family(p.values, p.budgets, p.base_rule,
                          [sc.BudgetPacing(0, 10, N + 1)])
    with pytest.raises(ValueError, match="unknown scenario axis"):
        sc.as_interventions({"bogus": 1.0})
    with pytest.raises(TypeError, match="not an Intervention"):
        sc.as_interventions([1.0])
    folded = sc.compile_family(
        p.values, p.budgets, p.base_rule,
        [[sc.ScaleBids(1.0), sc.ScaleBudgets(1.0),
          sc.BudgetPacing(3, 0, None)], [sc.BidNoise(0.0),
                                         sc.ParticipationJitter(1.0)]],
        key=_pkey(23))
    assert folded.overlay is None


# ---------------------------------------------------------------------------
# sweeps: every back-end, chunking and placement the CPU has
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,resolve", [
    ("static", "torch"), ("static", "fused"), ("static", "sweep_resolve"),
    ("pacing", "torch"), ("noise", "torch"), ("entrant", "torch"),
    ("entrant", "fused"), ("design", "fused")])
def test_family_sweep_is_the_reference(name, resolve):
    _, p = _engines()
    spend, caps = _reference_sweep(name)
    out = p.sweep(_families(name)[1], resolve=resolve)
    _same(spend, out.results.final_spend)
    _same(caps, out.results.cap_times)
    np.testing.assert_allclose(out.results.revenue.numpy(),
                               spend.sum(-1), rtol=1e-6)
    # every intervened lane moved off the base lane (the noise family's
    # sigma=0 / prob=1 lane is the base lane bit for bit)
    moved = [not np.array_equal(spend[s], spend[0])
             for s in range(1, len(spend))]
    assert moved == ([True, True, False] if name == "noise"
                     else [True] * len(moved))


@pytest.mark.parametrize("name,resolve", [
    ("static", "fused"), ("static", "sweep_resolve"), ("pacing", "torch"),
    ("noise", "torch")])
@pytest.mark.parametrize("chunking", [(64, 1), (128, 3)])
def test_family_sweep_chunked_is_the_reference(name, resolve, chunking):
    _, p = _engines()
    epc, spc = chunking
    fam = _families(name)[1]
    if fam.num_scenarios % spc:
        spc = 1
    spend, caps = _reference_sweep(name, epc, spc)
    _same(spend, _reference_sweep(name)[0])
    out = p.sweep(fam, resolve=resolve, chunks=epc, scenario_chunks=spc)
    _same(spend, out.results.final_spend)
    _same(caps, out.results.cap_times)


def test_family_carried_from_the_reference_sweeps_alike():
    """``interop.family_from_reference`` carries repro's compiled family
    (per-event overlay, key and all) into the port; its sweep is repro's
    bit for bit."""
    _, p = _engines()
    jfam, pfam = _families("noise")
    carried = family_from_reference(jfam, device="cpu")
    _same_overlay(jfam.overlay, carried.overlay)
    assert carried.fingerprints() == jfam.fingerprints()
    spend, caps = _reference_sweep("noise")
    out = p.sweep(carried, resolve="torch")
    _same(spend, out.results.final_spend)
    _same(caps, out.results.cap_times)
    assert overlay_from_reference(None) is None


@pytest.mark.parametrize("resolve", ["torch", "fused"])
@pytest.mark.parametrize("chunking", [(None, None), (64, 1)])
def test_null_overlay_bitwise_base(resolve, chunking):
    """A null overlay (full windows, sigma 0, prob 1, time-varying) is the
    overlay-free program bit for bit on both placements; on ``"fused"``
    the static form (a fold into the mask) is, as the per-event form is
    refused there."""
    env = _env()
    epc, spc = chunking
    key = _pkey(17)
    values = torch.from_numpy(np.array(env.values))
    b1 = torch.from_numpy(np.array(env.budgets))
    budgets = torch.stack([b1, b1 * 0.4])
    rules = AuctionRule(multipliers=torch.ones((2, C)),
                        reserve=torch.full((2,), 0.05), kind="first_price")
    per_event = resolve == "torch"
    full = dict(live_start=torch.zeros((2, C), dtype=torch.int32),
                live_stop=torch.full((2, C), N, dtype=torch.int32))
    extra = dict(bid_sigma=torch.zeros((2, C)), part_prob=torch.ones((2, C)),
                 key=key, time_varying=True) if per_event else {}
    ol = ScenarioOverlay(**full, **extra)
    kw = dict(resolve=resolve, chunks=epc, scenario_chunks=spc)
    want = sweep_parallel(values, budgets, rules, **kw)
    got = sweep_parallel(values, budgets, rules, overlay=ol, **kw)
    _same(want.final_spend, got.final_spend)
    _same(want.cap_times, got.cap_times)
    # placement="device": the overlay's fields are (C,) rows
    plan = SweepPlan(placement="device", resolve=resolve, chunks=epc,
                     scenario_chunks=spc)
    rule1 = AuctionRule(multipliers=rules.multipliers[1],
                        reserve=rules.reserve[1], kind=rules.kind)
    row = ol.map_fields(lambda x: x[1])
    ref1 = execute_sweep(values, budgets[1], rule1, plan)
    out1 = execute_sweep(values, budgets[1], rule1, plan, overlay=row)
    for a, b in zip(out1[:2], ref1[:2]):
        _same(b, a)


def test_device_placement_overlay_is_the_reference():
    """One unbatched lane under a per-event overlay row, against
    ``repro``'s device placement."""
    env = _env()
    jfam, pfam = _families("noise")
    s = 2
    jrule = JRule(multipliers=jfam.grid.rules.multipliers[s],
                  reserve=jfam.grid.rules.reserve[s], kind="first_price")
    jrow = JOverlay(**{f: getattr(jfam.overlay, f)[s]
                       for f in ScenarioOverlay.FIELDS},
                    key=jfam.overlay.key, time_varying=True)
    from repro.core import SweepPlan as JPlan, execute_sweep as j_exec
    want = j_exec(env.values, jfam.grid.budgets[s], jrule,
                  JPlan(placement="device", resolve="jnp"), overlay=jrow)
    rule = AuctionRule(multipliers=pfam.grid.rules.multipliers[s],
                       reserve=pfam.grid.rules.reserve[s],
                       kind="first_price")
    got = execute_sweep(pfam.values, pfam.grid.budgets[s], rule,
                        SweepPlan(placement="device", resolve="torch"),
                        overlay=pfam.overlay.map_fields(lambda x: x[s]))
    for a, b in zip(want, got):
        _same(a, b)


@pytest.mark.parametrize("resolve", ["fused", "sweep_resolve"])
def test_per_event_overlay_refused_by_kernel_back_ends(resolve):
    _, p = _engines()
    with pytest.raises(ValueError, match="torch resolve path only"):
        p.sweep(_families("noise")[1], resolve=resolve)


def test_per_event_overlay_refused_by_the_any_c_back_end():
    fam = _families("noise")[1]
    with pytest.raises(ValueError, match="torch resolve path only"):
        executor.check_overlay(fam.overlay, n_scenarios=fam.num_scenarios,
                               n_campaigns=C,
                               resolve=executor.ANY_C_BACKEND)


def test_overlay_contract_texts():
    ol = ScenarioOverlay(live_start=torch.zeros((2, C), dtype=torch.int32))
    check = functools.partial(executor.check_overlay, n_scenarios=2,
                              n_campaigns=C, resolve="torch")
    with pytest.raises(ValueError, match="BOTH live_start and live_stop"):
        check(ol)
    with pytest.raises(ValueError, match=r"must be \(S, C\)"):
        check(ScenarioOverlay(bid_sigma=torch.zeros((3, C)), key=_pkey(0)))
    with pytest.raises(ValueError, match="need ScenarioOverlay.key"):
        check(ScenarioOverlay(part_prob=torch.ones((2, C))))
    with pytest.raises(ValueError, match="time_varying only qualifies"):
        check(ScenarioOverlay(time_varying=True))


def test_overlay_family_rejects_other_methods():
    _, p = _engines()
    for method in ("sort2aggregate", "sequential"):
        with pytest.raises(ValueError, match="parallel executor only"):
            p.sweep(_families("static")[1], method=method)


def test_design_only_family_runs_sort2aggregate_like_the_reference():
    j, p = _engines()
    jfam, pfam = _families("design")
    assert pfam.overlay is None and pfam.labels[0] == "base"
    want = j.sweep(jfam, method="sort2aggregate", warm_start="base")
    got = p.sweep(pfam, method="sort2aggregate", warm_start="base")
    _same(want.results.cap_times, got.results.cap_times)
    _same(want.results.final_spend, got.results.final_spend)


# ---------------------------------------------------------------------------
# Algorithm 4 with an overlay
# ---------------------------------------------------------------------------

VI_KW = dict(sample_size=96, num_iters=3, batch_size=32)


@pytest.mark.parametrize("name", ["pacing", "noise"])
def test_estimate_pi_sweep_with_overlay_is_the_reference(name):
    j, p = _engines()
    jfam, pfam = _families(name)
    want = jvi.estimate_pi_sweep(jfam.values, jfam.grid.budgets,
                                 jfam.grid.rules, jax.random.PRNGKey(4),
                                 overlay=jfam.overlay, **VI_KW)
    got = vi.estimate_pi_sweep(pfam.values, pfam.grid.budgets,
                               pfam.grid.rules, _pkey(4),
                               overlay=pfam.overlay, **VI_KW)
    _same(want.pi, got.pi)
    plain = vi.estimate_pi_sweep(pfam.values, pfam.grid.budgets,
                                 pfam.grid.rules, _pkey(4), **VI_KW)
    assert not torch.equal(plain.pi[1:], got.pi[1:])


def test_estimate_pi_with_overlay_row_is_the_reference():
    j, p = _engines()
    jfam, pfam = _families("noise")
    s = 1
    jrow = JOverlay(**{f: None if getattr(jfam.overlay, f) is None
                       else getattr(jfam.overlay, f)[s]
                       for f in ScenarioOverlay.FIELDS},
                    key=jfam.overlay.key, time_varying=True)
    jrule = JRule(multipliers=jfam.grid.rules.multipliers[s],
                  reserve=jfam.grid.rules.reserve[s], kind="first_price")
    want = jvi.estimate_pi(jfam.values, jfam.grid.budgets[s], jrule,
                           jax.random.PRNGKey(8), track_every=2,
                           overlay_row=jrow, **VI_KW)
    rule = AuctionRule(multipliers=pfam.grid.rules.multipliers[s],
                       reserve=pfam.grid.rules.reserve[s],
                       kind="first_price")
    got = vi.estimate_pi(pfam.values, pfam.grid.budgets[s], rule, _pkey(8),
                         track_every=2, overlay_row=pfam.overlay.map_fields(
                             lambda x: x[s]), **VI_KW)
    _same(want.pi, got.pi)
    _same(want.history, got.history)
    with pytest.raises(ValueError, match="no CRN key"):
        vi.estimate_pi(pfam.values, pfam.grid.budgets[s], rule, _pkey(8),
                       overlay_row=ScenarioOverlay(
                           bid_sigma=torch.zeros(C)), **VI_KW)


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_vi_chain_ref_with_overlay_is_the_cpu_loop(kind):
    """The kernel's CPU mirror with per-lane rows and eligibility is
    bitwise the plain loop (``estimate_pi_sweep`` on the CPU)."""
    _, p = _engines()
    pfam = _families("noise")[1]
    s = pfam.num_scenarios
    rules = AuctionRule(multipliers=pfam.grid.rules.multipliers,
                        reserve=pfam.grid.rules.reserve, kind=kind)
    want = vi.estimate_pi_sweep(pfam.values, pfam.grid.budgets, rules,
                                _pkey(4), overlay=pfam.overlay, **VI_KW)
    draws = vi._draws(_pkey(4), N, pfam.values.shape[1],
                      sample_size=96, num_iters=3, batch_size=32,
                      coupling="shared", device="cpu")
    chain = vi._chain(pfam.values, pfam.grid.budgets, draws, sample_size=96,
                      batch_size=32, eta=0.5, eta_decay=0.0,
                      overlay=pfam.overlay)
    assert chain.sampled.shape[0] == s and chain.elig.shape[0] == s
    got, _ = ref.vi_chain_ref(chain.sampled, draws.u, chain.step,
                              chain.denom, chain.btilde, rules.multipliers,
                              rules.reserve, torch.ones((s, C)),
                              sample_size=96, second_price=kind !=
                              "first_price", elig=chain.elig)
    _same(want.pi, got)


# ---------------------------------------------------------------------------
# goldens: the dyadic 3 x 8 log of tests/test_scenarios.py
# ---------------------------------------------------------------------------

GOLDEN_ROWS = [
    [.5, .75, .25], [.25, .5, .125], [.75, .25, .5], [.125, .75, .25],
    [.5, .25, .75], [.25, .5, .75], [.5, .25, .25], [.25, .5, .25],
]


def _golden_engine(budgets=(10.0, 10.0, 10.0)):
    return CounterfactualEngine(
        torch.tensor(GOLDEN_ROWS), torch.tensor(budgets),
        AuctionRule.first_price(3, device="cpu"), device="cpu")


def test_golden_pause_boost_and_entrant():
    eng = _golden_engine()
    fam = sc.compile_family(
        eng.values, eng.budgets, eng.base_rule,
        [sc.PauseCampaign(1), sc.BoostCampaign(2, 2.0),
         [sc.PauseCampaign(1), sc.BoostCampaign(2, 2.0)],
         sc.AddEntrant(budget=10.0, values=np.ones(8, np.float32),
                       slot="newco")])
    swept = eng.sweep(fam)
    spend = swept.results.final_spend.numpy()
    np.testing.assert_array_equal(spend[:, :3], np.float32(
        [[1.25, 2.5, 1.5], [2.25, 0, 1.75], [.5, 2.5, 4.0],
         [1.25, 0, 5.0], [0, 0, 0]]))
    np.testing.assert_array_equal(spend[:, 3], np.float32([0, 0, 0, 0, 8]))
    assert swept.results.cap_times[1, 1] == 9
    assert swept.results.revenue.tolist() == [5.25, 4.0, 7.0, 6.25, 8.0]


def test_golden_capped_algorithm2_semantics():
    eng = _golden_engine((10.0, 1.0, 10.0))
    swept = eng.sweep(sc.compile_family(eng.values, eng.budgets,
                                        eng.base_rule, []))
    _same(np.float32([[1.5, 1.25, 1.75]]), swept.results.final_spend)
    _same(np.int32([[9, 4, 9]]), swept.results.cap_times)


def test_golden_shapley_efficiency_exact():
    att = _golden_engine().attribute({"pause1": sc.PauseCampaign(1),
                                      "boost2": sc.BoostCampaign(2, 2.0)})
    assert att.phi == {"pause1": -1.0, "boost2": 2.0}
    assert att.base_value == 5.25 and att.total_value == 6.25
    assert att.total_delta == 1.0
    assert att.efficiency_gap == 0.0
    assert "pause1" in att.format_table()
    assert sc.shapley_values(("a", "b"), {
        frozenset(): 5.25, frozenset({"a"}): 4.0, frozenset({"b"}): 7.0,
        frozenset({"a", "b"}): 6.25}) == {"a": -1.0, "b": 2.0}
    with pytest.raises(ValueError, match="missing"):
        sc.shapley_values(("a", "b"), {frozenset(): 1.0})


@pytest.mark.parametrize("objective", ["revenue", "spend"])
def test_shapley_attribution_is_the_reference(objective):
    """Three axes on the synthetic day, one of them noisy: the port's
    Shapley values equal repro's at rtol 1e-6 (revenue differs in its last
    bits), efficiency within one float rounding."""
    j, p = _engines()
    axes = lambda m: {"boost": m.BoostCampaign(2, 1.5),
                      "pause": m.PauseCampaign(5),
                      "noise": m.BidNoise(0.3)}
    want = j.attribute(axes(jsc), objective=objective,
                       key=jax.random.PRNGKey(11))
    got = p.attribute(axes(sc), objective=objective, key=_pkey(11))
    assert len(got.subset_values) == 8
    for a in want.axes:
        np.testing.assert_allclose(got.phi[a], want.phi[a], rtol=1e-6)
    assert got.efficiency_gap <= 1e-6 * max(1.0, abs(got.total_delta))


# ---------------------------------------------------------------------------
# CRN metamorphic properties (tests/test_scenarios.py:307-377)
# ---------------------------------------------------------------------------

PANEL = lambda m: [
    (m.PauseCampaign(3),),
    (m.BoostCampaign(1, 1.7), m.BudgetPacing(4, start=128, stop=384)),
    (m.BidNoise(0.3), m.ParticipationJitter(0.8, campaign=2)),
    (m.BudgetPacing(0, start=65, stop=257), m.BidNoise(0.2, campaign=5),
     m.PauseCampaign(6)),
]


def _spends_caps(swept):
    return (swept.results.final_spend.numpy(),
            swept.results.cap_times.numpy())


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("chunking", [(None, None), (64, 1), (128, 3)])
def test_crn_identical_specs_identical_lanes_any_chunking(i, chunking):
    _, eng = _engines()
    spec = PANEL(sc)[i]
    epc, spc = chunking
    fam = sc.compile_family(eng.values, eng.budgets, eng.base_rule,
                            [spec, spec], key=_pkey(FAMILY_KEY))
    spend, caps = _spends_caps(eng.sweep(fam, resolve="torch"))
    np.testing.assert_array_equal(spend[2], spend[1])
    np.testing.assert_array_equal(caps[2], caps[1])
    out = eng.sweep(fam, resolve="torch", chunks=epc, scenario_chunks=spc)
    _same(spend, out.results.final_spend)
    _same(caps, out.results.cap_times)


@pytest.mark.parametrize("i", range(3))
def test_crn_membership_and_order_independence(i):
    """Adding a scenario never moves another lane's bits, and permuting
    the scenarios permutes the results."""
    _, eng = _engines()
    a, b = PANEL(sc)[i], PANEL(sc)[i + 1]
    key = _pkey(FAMILY_KEY)
    fam = lambda specs: sc.compile_family(eng.values, eng.budgets,
                                          eng.base_rule, specs, key=key)
    sp_a, ct_a = _spends_caps(eng.sweep(fam([a]), resolve="torch"))
    sp_ab, ct_ab = _spends_caps(eng.sweep(fam([a, b]), resolve="torch"))
    sp_ba, ct_ba = _spends_caps(eng.sweep(fam([b, a]), resolve="torch"))
    np.testing.assert_array_equal(sp_ab[:2], sp_a)
    np.testing.assert_array_equal(ct_ab[:2], ct_a)
    np.testing.assert_array_equal(sp_ab[1], sp_ba[2])
    np.testing.assert_array_equal(sp_ab[2], sp_ba[1])
    np.testing.assert_array_equal(ct_ab[1], ct_ba[2])


@pytest.mark.parametrize("c", [0, 5])
@pytest.mark.parametrize("i", range(3))
def test_pause_property(c, i):
    _, eng = _engines()
    fam = sc.compile_family(eng.values, eng.budgets, eng.base_rule,
                            [tuple(PANEL(sc)[i]) + (sc.PauseCampaign(c),)],
                            key=_pkey(FAMILY_KEY))
    spend, caps = _spends_caps(eng.sweep(fam, resolve="torch"))
    assert spend[1, c] == 0.0
    assert caps[1, c] == N + 1
