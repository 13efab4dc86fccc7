"""Event and scenario chunks in the port against ``repro`` on the same
inputs (``repro.data.make_synthetic_env``, N=4096, C=16, S=8), bit for
bit: the chunked and scenario-chunked Algorithm-2 sweep on the ``torch``
and ``fused`` (plain-version) back-ends, every output against ``repro``'s
chunked sweep and the port's unchunked one; the chunked SORT2AGGREGATE
sweep; the carried first-crossing scan and the segment resolve at a row
offset that it runs on; the alignment errors' texts; and the Hopper gate of
the one-launch round (``planned_scenario_chunk``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import sweep_sort2aggregate as j_sweep_s2a  # noqa: E402
from repro.core import sweep_state_machine as j_ssm  # noqa: E402
from repro.core import CounterfactualEngine as JEngine  # noqa: E402
from repro.core.sort2aggregate import \
    refine_fixed_chunked as j_refine_chunked  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import (ChunkSpec, CounterfactualEngine,  # noqa: E402
                              ScenarioChunkSpec, Segments, SweepPlan,
                              executor, refine_fixed_chunked, segments,
                              sweep_parallel, sweep_sort2aggregate,
                              sweep_state_machine)
from repro_torch.kernels.auction_resolve import ref  # noqa: E402
from repro_torch.kernels.capped_scan.ref import (  # noqa: E402
    capped_scan_ref, capped_scan_windows_ref)
from repro_torch.interop import from_reference  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS, N_CAMPAIGNS = 4096, 16
BLOCK = N_EVENTS // 32                  # the canonical reduction block
KINDS = ("first_price", "second_price")


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(1), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


def _grid(env, kind):
    rule = JRule(multipliers=jnp.ones((N_CAMPAIGNS,), jnp.float32),
                 reserve=jnp.float32(0.0), kind=kind)
    return JGrid.product(rule, env.budgets, bid_scales=[1.0, 0.9, 1.1, 1.3],
                         reserves=[0.0, 0.05])


def _port(env, grid):
    return from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device="cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def _same_outputs(want, got):
    assert len(want) == len(got) == 6
    for a, b in zip(want, got):
        _same(a, b)


def _message(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value), str(err.value)


@pytest.fixture(scope="module")
def sweeps(env):
    """Per rule: the grid, the port's inputs and the port's unchunked
    sweep (the bits every chunking must give)."""
    out = {}
    for kind in KINDS:
        grid = _grid(env, kind)
        values, t_grid = _port(env, grid)
        base = sweep_state_machine(values, t_grid.budgets, t_grid.rules,
                                   resolve="torch")
        out[kind] = (grid, values, t_grid, base)
    return out


# ---------------------------------------------------------------------------
# Algorithm 2 over event and scenario chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_chunked_sweep_is_repros_chunked_sweep(env, sweeps, kind):
    """``chunks=1024`` (8 canonical blocks a chunk) on the torch path:
    every output bit for bit ``repro``'s chunked sweep."""
    grid, values, t_grid, _ = sweeps[kind]
    want = j_ssm(env.values, grid.budgets, grid.rules, resolve="jnp",
                 chunks=1024)
    got = sweep_state_machine(values, t_grid.budgets, t_grid.rules,
                              resolve="torch", chunks=1024)
    _same_outputs(want, got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("resolve", ["torch", "fused"])
@pytest.mark.parametrize("chunks", [BLOCK, 512, N_EVENTS,
                                    ChunkSpec(events_per_chunk=2048)])
def test_chunked_sweep_is_the_unchunked_sweep(sweeps, kind, resolve, chunks):
    """Every aligned chunk size (one canonical block, four, the whole
    log, a ChunkSpec) gives the unchunked sweep's six outputs, on the
    torch path and on the fused round's plain version."""
    _, values, t_grid, base = sweeps[kind]
    got = sweep_state_machine(values, t_grid.budgets, t_grid.rules,
                              resolve=resolve, chunks=chunks)
    _same_outputs(base, got)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("spc", [1, 2, 4, ScenarioChunkSpec(8)])
def test_scenario_chunks_are_the_unchunked_sweep(sweeps, kind, spc):
    _, values, t_grid, base = sweeps[kind]
    got = sweep_state_machine(values, t_grid.budgets, t_grid.rules,
                              resolve="fused", scenario_chunks=spc)
    _same_outputs(base, got)


@pytest.mark.parametrize("kind", KINDS)
def test_scenario_and_event_chunks_together_are_repros(env, sweeps, kind):
    grid, values, t_grid, base = sweeps[kind]
    want = j_ssm(env.values, grid.budgets, grid.rules, resolve="jnp",
                 chunks=2048, scenario_chunks=4)
    got = sweep_state_machine(values, t_grid.budgets, t_grid.rules,
                              resolve="torch", chunks=2048,
                              scenario_chunks=4)
    _same_outputs(want, got)
    _same_outputs(base, got)


def test_engine_sweep_and_sweep_parallel_take_both_axes(env, sweeps):
    _, values, t_grid, base = sweeps["second_price"]
    engine = CounterfactualEngine(values, _t(env.budgets), device="cpu")
    res = engine.sweep(t_grid, chunks=1024, scenario_chunks=2).results
    _same(base[0], res.final_spend)
    _same(base[1], res.cap_times)
    sim = sweep_parallel(values, t_grid.budgets, t_grid.rules,
                         chunks=ChunkSpec(512), scenario_chunks=4)
    _same(base[0], sim.final_spend)
    _same(base[1], sim.cap_times)
    solo = executor.execute_sweep(
        values, t_grid.budgets[3], t_grid.scenario(3)[0],
        SweepPlan(placement="device", chunks=256))
    for a, b in zip(base, solo):
        _same(a[3], b)


# ---------------------------------------------------------------------------
# Alignment errors and plan checks: repro's texts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(chunks=100), dict(chunks=384),
                                dict(scenario_chunks=3),
                                dict(chunks=0), dict(scenario_chunks=0)],
                         ids=["grid", "ragged", "ragged_s", "zero",
                              "zero_s"])
def test_alignment_errors_are_repros(env, sweeps, kw):
    grid, values, t_grid, _ = sweeps["first_price"]
    assert _message(lambda: sweep_state_machine(
        values, t_grid.budgets, t_grid.rules, resolve="torch", **kw)) == \
        _message(lambda: j_ssm(env.values, grid.budgets, grid.rules,
                               resolve="jnp", **kw))


def test_chunk_spec_errors_are_repros():
    from repro.core.executor import ChunkSpec as JChunkSpec
    from repro.core.executor import ScenarioChunkSpec as JScenarioChunkSpec
    for args, kw in (((128,), dict(source="disk")), ((-1,), {})):
        assert _message(lambda: ChunkSpec(*args, **kw)) == \
            _message(lambda: JChunkSpec(*args, **kw))
    assert _message(lambda: ScenarioChunkSpec(0)) == \
        _message(lambda: JScenarioChunkSpec(0))


def test_s2a_alignment_and_plan_errors_are_repros(env, sweeps):
    grid, values, t_grid, _ = sweeps["first_price"]
    for kw in (dict(chunks=1000, crossing_block=256),     # block grid
               dict(chunks=1536, crossing_block=256),     # ragged
               dict(chunks=1024, record_events=True)):
        assert _message(lambda: sweep_sort2aggregate(
            values, t_grid.budgets, t_grid.rules, refine_iters=1, **kw)) == \
            _message(lambda: j_sweep_s2a(env.values, grid.budgets,
                                         grid.rules, refine_iters=1, **kw))
    from repro.core.executor import ChunkSpec as JChunkSpec
    from repro.core.executor import SweepPlan as JPlan
    from repro.core.executor import check_s2a_options as j_check
    host = dict(events_per_chunk=1024, source="host")
    for plan, j_plan, rec in (
            (SweepPlan(chunks=ChunkSpec(**host)),
             JPlan(chunks=JChunkSpec(**host)), False),
            (SweepPlan(chunks=1024), JPlan(chunks=1024), True),
            (SweepPlan(scenario_chunks=2), JPlan(scenario_chunks=2), False)):
        assert _message(lambda: executor.check_s2a_options(plan, rec)) == \
            _message(lambda: j_check(j_plan, rec))


@pytest.mark.parametrize("kind", KINDS)
def test_host_streamed_sweep_is_repros(env, sweeps, kind):
    """The log streamed from host memory in chunks of 1,024 (an in-memory
    log copied once, and a ``HostStream`` of three slabs, one chunk
    straddling two of them): every output bitwise ``repro``'s
    host-streamed sweep and the port's unchunked one."""
    from repro.core.executor import ChunkSpec as JChunkSpec
    from repro.core.executor import SweepPlan as JPlan
    from repro.core.executor import execute_sweep as j_execute_sweep
    grid, values, t_grid, ref_port = sweeps[kind]
    want = j_execute_sweep(env.values, grid.budgets, grid.rules, JPlan(
        chunks=JChunkSpec(1024, source="host")))
    got = sweep_state_machine(values, t_grid.budgets, t_grid.rules,
                              chunks=ChunkSpec(1024, source="host"))
    stream = executor.HostStream([values[:1500], values[1500:3000],
                                  values[3000:]])
    from_slabs = executor.execute_sweep(stream, t_grid.budgets,
                                        t_grid.rules, SweepPlan(chunks=1024))
    for a, b, c, d in zip(want, got, from_slabs, ref_port):
        _same(a, b)
        _same(a, c)
        _same(a, d)


def test_planned_scenario_chunk_on_the_hopper_gate():
    """An explicit chunk wins; otherwise a chunk is picked only for the
    fused round on CUDA when C does not fit, and since S never enters the
    Hopper gate no chunk fits then either."""
    fused = SweepPlan(resolve="fused")
    assert executor.planned_scenario_chunk(
        SweepPlan(scenario_chunks=4), 32, 100, device="cpu") == 4
    assert executor.planned_scenario_chunk(
        SweepPlan(scenario_chunks=4), 32, 100, device="cuda", limit=10) == 4
    assert executor.planned_scenario_chunk(fused, 32, 100, device="cpu",
                                           limit=10) is None
    assert executor.planned_scenario_chunk(fused, 32, 100, device="cuda",
                                           limit=100) is None
    assert executor.planned_scenario_chunk(fused, 32, 101, device="cuda",
                                           limit=100) is None
    assert executor.planned_scenario_chunk(
        SweepPlan(resolve="fused", chunks=1024), 32, 101, device="cuda",
        limit=100) is None
    for s in (1, 32, 4096):
        assert executor.round_fused_fits(s, 100, limit=100)
        assert not executor.round_fused_fits(s, 101, limit=100)
    assert executor.fitting_scenario_chunk(32, 100, limit=100) == 32
    assert executor.fitting_scenario_chunk(32, 101, limit=100) is None


# ---------------------------------------------------------------------------
# The chunked SORT2AGGREGATE sweep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def s2a(env):
    """Per rule: the port's unchunked sweep at crossing_block=256 from the
    all-active start, and the warm start the chunked runs share."""
    out = {}
    for kind in KINDS:
        grid = _grid(env, kind)
        values, t_grid = _port(env, grid)
        base = sweep_sort2aggregate(values, t_grid.budgets, t_grid.rules,
                                    refine_iters=4, crossing_block=256)
        out[kind] = (grid, values, t_grid, base)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_s2a_sweep_is_repros(env, s2a, kind):
    grid, values, t_grid, base = s2a[kind]
    want = j_sweep_s2a(env.values, grid.budgets, grid.rules, refine_iters=4,
                       chunks=1024, crossing_block=256)
    got = sweep_sort2aggregate(values, t_grid.budgets, t_grid.rules,
                               refine_iters=4, chunks=1024,
                               crossing_block=256)
    _same(want[0].final_spend, got[0].final_spend)
    _same(want[0].cap_times, got[0].cap_times)
    _same(want[0].segments.boundaries, got[0].segments.boundaries)
    _same(want[1], got[1])
    _same(want[2], got[2])
    # cap times, gaps and iterations are the unchunked sweep's
    _same(base[0].cap_times, got[0].cap_times)
    _same(base[1], got[1])
    _same(base[2], got[2])
    # final_spend is the blockwise running total, the unchunked one the
    # flat sum: the same float32 numbers added in another association
    # (a few thousand sales a campaign, each add within half an ulp)
    np.testing.assert_allclose(got[0].final_spend.numpy(),
                               base[0].final_spend.numpy(), rtol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_s2a_final_spend_is_bitwise_across_chunk_sizes(s2a, kind):
    _, values, t_grid, base = s2a[kind]
    caps0 = base[0].cap_times + 3          # a warm start off the answer
    runs = [refine_fixed_chunked(values, t_grid.budgets, t_grid.rules,
                                 caps0, chunk_events=epc, refine_iters=2,
                                 crossing_block=256)
            for epc in (256, 2048, N_EVENTS)]
    for other in runs[1:]:
        for a, b in zip(runs[0][1:], other[1:]):
            _same(a, b)
        _same(runs[0][0].final_spend, other[0].final_spend)
        _same(runs[0][0].cap_times, other[0].cap_times)


def test_engine_chunked_s2a_sweep_is_repros(env):
    """The engine's chunked sort2aggregate sweep, base warm start, both
    sides from the same engine inputs."""
    j_engine = JEngine(env.values, env.budgets,
                       JRule.second_price(N_CAMPAIGNS))
    t_engine = CounterfactualEngine(_t(env.values), _t(env.budgets),
                                    device="cpu")
    t_engine.base_rule = type(t_engine.base_rule).second_price(
        N_CAMPAIGNS, device="cpu")
    kw = dict(method="sort2aggregate", chunks=2048, crossing_block=512,
              refine_iters=3)
    want = j_engine.sweep(j_engine.grid(bid_scales=[1.0, 1.2]), **kw)
    got = t_engine.sweep(t_engine.grid(bid_scales=[1.0, 1.2]), **kw)
    _same(want.results.final_spend, got.results.final_spend)
    _same(want.results.cap_times, got.results.cap_times)
    _same(want.consistency_gaps, got.consistency_gaps)
    _same(want.refine_iters, got.refine_iters)


def test_refine_fixed_chunked_one_lane_is_repros(env):
    """One lane against ``repro``'s single-design chunked spine."""
    rule = JRule(multipliers=jnp.linspace(0.9, 1.2, N_CAMPAIGNS,
                                          dtype=jnp.float32),
                 reserve=jnp.float32(0.02), kind="first_price")
    caps0 = jnp.full((N_CAMPAIGNS,), N_EVENTS + 1, jnp.int32)
    want = j_refine_chunked(env.values, env.budgets, rule, caps0,
                            chunk_events=512, refine_iters=3,
                            crossing_block=128)
    values, grid = from_reference(
        np.asarray(env.values), np.asarray(env.budgets)[None],
        np.asarray(rule.multipliers)[None],
        np.asarray(rule.reserve)[None], rule.kind, device="cpu")
    got = refine_fixed_chunked(values, grid.budgets, grid.rules,
                               _t(caps0)[None], chunk_events=512,
                               refine_iters=3, crossing_block=128)
    _same(want[0].final_spend, got[0].final_spend[0])
    _same(want[0].cap_times, got[0].cap_times[0])
    _same(want[1], got[1][0])
    _same(want[2], got[2][0])


# ---------------------------------------------------------------------------
# What the chunked replay runs on: the carried crossing scan, the segment
# resolve at an offset, and the sampled replay's divisor
# ---------------------------------------------------------------------------

def _crossing_inputs(s, n, c, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(-1, c, (s, n)).astype(np.int32)
    p = np.where(w >= 0, rng.random((s, n)), 0.0).astype(np.float32)
    budgets = rng.uniform(5.0, 120.0, (s, c)).astype(np.float32)
    budgets[:, -2:] = [0.0, -1.0]
    return w, p, budgets


@pytest.mark.parametrize("block", [256, 128, 16])
@pytest.mark.parametrize("epc", [1024, 512])
def test_carried_crossing_scan_is_one_call(block, epc):
    """Chunk by chunk with a carry, the plain version and the kernel's CPU
    mirror both give one whole-log call's cap times and its running total;
    a chunk boundary falls on a crossing (campaign 0 of lane 0 reaches its
    budget on the chunk's last row)."""
    s, n, c = 2, 3072, 12
    w, p, budgets = _crossing_inputs(s, n, c, seed=block)
    # the boundary crossing: campaign 0 of lane 0 sells on the first
    # chunk's last row, and its budget is its running spend there
    w[0, epc - 1], p[0, epc - 1] = 0, 0.75
    s0, _ = segments._crossing_scan(
        _t(w[:, :epc]), _t(p[:, :epc]), _t(budgets), c, block,
        torch.zeros((s, c)), torch.full((s, c), n + 1, dtype=torch.int32),
        0, n + 1)
    budgets[0, 0] = float(s0[0, 0])
    whole = segments.first_crossing_ref(_t(w), _t(p), _t(budgets), c, block)
    assert int(whole[0, 0]) == epc
    state = dict(plain=(torch.zeros((s, c)),
                        torch.full((s, c), n + 1, dtype=torch.int32)),
                 mirror=(torch.zeros((s, c)),
                         torch.full((s, c), n + 1, dtype=torch.int32)))
    for off in range(0, n, epc):
        sl = slice(off, off + epc)
        state["plain"] = segments.crossing_carry(
            _t(w[:, sl]), _t(p[:, sl]), _t(budgets), c, block,
            s0=state["plain"][0], cap=state["plain"][1], offset=off,
            n_global=n)
        _, m_cap, m_s0 = segments.first_crossing_blocks_ref(
            _t(w[:, sl]), _t(p[:, sl]), _t(budgets), c, block,
            s0=state["mirror"][0], cap=state["mirror"][1], offset=off,
            n_global=n)
        state["mirror"] = (m_s0, m_cap)
    for _, cap_k in state.values():
        _same(whole, torch.clamp(cap_k, max=n + 1))
    _same(state["plain"][0], state["mirror"][0])
    # the carried total is repro's running spend of the whole log
    want_s0 = np.stack([_repro_running_total(w[k], p[k], c, block)
                        for k in range(s)])
    _same(want_s0, state["plain"][0])
    with pytest.raises(ValueError, match="crossing block"):
        segments.crossing_carry(_t(w[:, 8:]), _t(p[:, 8:]), _t(budgets), c,
                                block, s0=state["plain"][0],
                                cap=state["plain"][1], offset=8, n_global=n)


@pytest.mark.parametrize("block,epc", [(4097, 8194), (8192 + 100, 8292)])
@pytest.mark.parametrize("spend", [True, False])
def test_carried_crossing_scan_splits_tiles(block, epc, spend):
    """Chunk by chunk with a carry, crossing blocks longer than the
    kernel's 4,096-row tile (4,097: a whole tile and a one-row one; 8,292:
    two whole tiles and a 100-row one): the kernel's CPU mirror, with the
    spends and in its caps-only mode, gives the plain version's carry at
    every chunk, one whole-log call's cap times and ``repro``'s running
    total; a chunk boundary falls on a crossing."""
    s, n, c = 2, 3 * epc, 12
    w, p, budgets = _crossing_inputs(s, n, c, seed=block + epc)
    w[0, epc - 1], p[0, epc - 1] = 0, 0.75
    s0, _ = segments._crossing_scan(
        _t(w[:, :epc]), _t(p[:, :epc]), _t(budgets), c, block,
        torch.zeros((s, c)), torch.full((s, c), n + 1, dtype=torch.int32),
        0, n + 1)
    budgets[0, 0] = float(s0[0, 0])
    whole = segments.first_crossing_ref(_t(w), _t(p), _t(budgets), c, block)
    assert int(whole[0, 0]) == epc
    zero = (torch.zeros((s, c)), torch.full((s, c), n + 1,
                                            dtype=torch.int32))
    plain, mirror = zero, zero
    for off in range(0, n, epc):
        sl = slice(off, off + epc)
        plain = segments.crossing_carry(
            _t(w[:, sl]), _t(p[:, sl]), _t(budgets), c, block, s0=plain[0],
            cap=plain[1], offset=off, n_global=n)
        spends, m_cap, m_s0 = segments.first_crossing_blocks_ref(
            _t(w[:, sl]), _t(p[:, sl]), _t(budgets), c, block, s0=mirror[0],
            cap=mirror[1], offset=off, n_global=n, spend=spend)
        assert (spends is None) == (not spend)
        mirror = (m_s0, m_cap)
        _same(plain[0], mirror[0])
        _same(plain[1], mirror[1])
    _same(whole, torch.clamp(mirror[1], max=n + 1))
    want_s0 = np.stack([_repro_running_total(w[k], p[k], c, block)
                        for k in range(s)])
    _same(want_s0, mirror[0])
    assert bool((whole < n).sum() > 2)


def _repro_running_total(w, p, c, block):
    """``repro``'s blockwise running spend after the last row (the carry of
    its chunked spine), one lane."""
    s0 = jnp.zeros((c,), jnp.float32)
    for lo in range(0, w.shape[0], block):
        sm = jax.nn.one_hot(jnp.asarray(w[lo:lo + block]), c,
                            dtype=jnp.float32) * jnp.asarray(
                                p[lo:lo + block])[:, None]
        s0 = (s0[None, :] + jnp.cumsum(sm, axis=0))[-1]
    return np.asarray(s0)


@pytest.mark.parametrize("offset", [0, 128, 640, 1000])
def test_segment_resolve_at_an_offset_is_the_slice_of_a_whole_call(offset):
    """Rows [offset, offset + 384) resolved at ``offset``: the plain
    version and the kernel's split give the same rows of a whole-log call,
    with boundaries before, inside and after the window and duplicates."""
    rng = np.random.default_rng(offset)
    n, c, s, rows = 2048, 9, 5, 384
    values = torch.from_numpy(rng.random((n, c), dtype=np.float32))
    caps = torch.from_numpy(rng.integers(1, n + 2, (s, c)).astype(np.int32))
    caps[0, :3] = offset + 5
    caps[1, 0] = offset
    caps[2, :] = n + 1
    segs = Segments.from_cap_times(caps, n)
    mult = torch.from_numpy(rng.uniform(0.8, 1.2, (s, c)).astype(np.float32))
    res = torch.from_numpy(rng.uniform(0.0, 0.1, s).astype(np.float32))
    for second in (False, True):
        w_all, p_all = ref.segment_resolve_plain(
            values, mult, res, segs.boundaries, segs.masks, second)
        sl = slice(offset, offset + rows)
        for fn in (ref.segment_resolve_plain, ref.segment_resolve_ref):
            w, p = fn(values[sl], mult, res, segs.boundaries, segs.masks,
                      second, offset=offset)
            _same(w_all[:, sl], w)
            _same(p_all[:, sl], p)


@pytest.mark.parametrize("scale", [1.0, 100.0, 3.3333333])
def test_capped_scan_scale_mirror_is_the_plain_version(scale):
    """The capped scan with a scale on each sale's spend increment (the
    sampled replay's 1/rho): the kernel's windowed split is the plain
    version, bit for bit."""
    rng = np.random.default_rng(3)
    n, c, s = 700, 9, 3
    values = torch.from_numpy(rng.random((n, c), dtype=np.float32))
    b = torch.from_numpy(rng.uniform(1.0, 8.0, (s, c)).astype(np.float32))
    b[0, 0] = 0.0
    mult = torch.from_numpy(rng.uniform(0.5, 1.5, (s, c)).astype(np.float32))
    res = torch.tensor([0.0, 0.05, 0.1])
    for second in (False, True):
        want = capped_scan_ref(values, b * scale, mult, res, second,
                               scale=scale)
        got = capped_scan_windows_ref(values, b * scale, mult, res, second,
                                      window=64, scale=scale)
        for a, g in zip(want, got):
            _same(a, g)
        assert int((want[3] <= n).sum()) > 1
