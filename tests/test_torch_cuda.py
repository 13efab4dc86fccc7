"""The CUDA kernels against their plain versions, on a card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA device. This file imports neither ``jax`` nor
``repro``, so it also runs where only PyTorch is installed (then without
the JAX-importing ``tests/conftest.py``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Event-ordered sums make the kernels bitwise the plain versions on the CPU.
The plain versions on the card sum with atomics (``index_add_``), so
against those the partials are only close.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              auction, parallel_simulate, segments,
                              sequential_replay, sweep_sequential,
                              sweep_state_machine)
from repro_torch.core.segments import REDUCE_BLOCKS as G  # noqa: E402
from repro_torch.data import make_synthetic_env  # noqa: E402
from repro_torch.kernels.auction_resolve import ops, ref  # noqa: E402
from repro_torch.kernels.auction_resolve import \
    auction_resolve as cuda_ar  # noqa: E402
from repro_torch.kernels.auction_resolve import \
    first_crossing as cuda_fc  # noqa: E402
from repro_torch.kernels.auction_resolve import round_fused as cuda_rf  # noqa: E402
from repro_torch.kernels.auction_resolve import \
    segment_partials as cuda_sp  # noqa: E402
from repro_torch.kernels.auction_resolve import \
    sweep_resolve as cuda_sr  # noqa: E402
from repro_torch.kernels.capped_scan import capped_scan as cuda_cs  # noqa: E402
from repro_torch.kernels.capped_scan import ops as scan_ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(s, n, c, seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        values=rng.uniform(0.0, 1.0, (n, c)).astype(np.float32),
        mult=rng.uniform(0.5, 1.5, (s, c)).astype(np.float32),
        act=rng.uniform(size=(s, c)) < 0.8,
        res=rng.uniform(0.0, 0.05, s).astype(np.float32),
        b=rng.uniform(2.0, 20.0, (s, c)).astype(np.float32),
        s_hat=rng.uniform(0.0, 1.0, (s, c)).astype(np.float32),
        n_hat=(np.arange(s, dtype=np.int32) * (n // (2 * s))),
    )
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize("sp", [False, True])
def test_round_fused_matches_plain(dev, sp):
    s, n, c = 6, 5000, 37
    x = _inputs(s, n, c, seed=2)
    keys = ("values", "mult", "act", "res", "b", "s_hat", "n_hat")
    args = [x[k].to(dev) for k in keys]
    alive = torch.ones(s, dtype=torch.bool, device=dev)
    before = cuda_rf.LAUNCHES["round_fused"]
    out = ops.round_fused(*args, alive, reduce_blocks=G, second_price=sp)
    torch.cuda.synchronize()
    assert cuda_rf.LAUNCHES["round_fused"] == before + 1
    block = -(-n // G)
    on_card = ref.round_fused_ref(*args, block_size=block, second_price=sp)
    on_cpu = ref.round_fused_ref(*[x[k] for k in keys], block_size=block,
                                 second_price=sp)
    for a, b, c in zip(out, on_card, on_cpu):
        assert torch.equal(a.cpu(), c)
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(a, b)


def test_sweep_partials_offset_window_and_skipped_lanes(dev):
    """A slice of the log at a non-zero offset, a window per lane, dead
    lanes that ``skip_retired`` leaves at exact zeros, and C above the
    kernel's 128-campaign staging width."""
    s, n_global, c = 8, 6000, 150
    x = _inputs(s, n_global, c, seed=3)
    offset, n_local = 1000, 3000
    v_local = x["values"][offset:offset + n_local]
    lo = torch.arange(s, dtype=torch.int32) * 400 + 500
    hi = lo + 2500
    alive = torch.arange(s) % 3 != 2
    out = ops.sweep_partials(
        v_local.to(dev), x["mult"].to(dev), x["act"].to(dev),
        x["res"].to(dev), lo.to(dev), hi.to(dev), alive.to(dev), offset,
        n_events_global=n_global, reduce_blocks=G, second_price=True)
    torch.cuda.synchronize()
    want = ref.fused_partials_ref(
        v_local, x["mult"], x["act"], x["res"], lo, hi,
        block_size=-(-n_global // G), second_price=True,
        index_offset=offset)
    out = out.cpu()
    assert torch.equal(out[alive], want[alive])
    assert not out[~alive].any()


def test_fused_sweep_bitwise_the_cpu_torch_path(dev):
    env = make_synthetic_env(4, n_events=4096, n_campaigns=16, emb_dim=8,
                             device="cpu")
    budgets = torch.stack([env.budgets, env.budgets * 0.5, env.budgets * 2])
    rules = AuctionRule(
        multipliers=torch.stack([env.rule.multipliers * m
                                 for m in (1.0, 1.2, 0.9)]),
        reserve=torch.tensor([0.0, 0.05, 0.0]), kind="second_price")
    on_cpu = sweep_state_machine(env.values, budgets, rules, resolve="torch")
    on_card = sweep_state_machine(
        env.values.to(dev), budgets.to(dev),
        AuctionRule(multipliers=rules.multipliers.to(dev),
                    reserve=rules.reserve.to(dev), kind=rules.kind))
    for a, b in zip(on_card, on_cpu):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# Event-ordered partials: the repair of index_add_'s atomics on CUDA
# ---------------------------------------------------------------------------

def _log(s, n, c, seed):
    """Resolved events: winners in [-1, C) and positive prices."""
    rng = np.random.default_rng(seed)
    winners = rng.integers(-1, c, (s, n)).astype(np.int32)
    prices = rng.uniform(0.01, 1.0, (s, n)).astype(np.float32)
    return torch.from_numpy(winners), torch.from_numpy(prices)


def test_partial_spend_sums_on_the_card_gives_the_cpu_bits(dev):
    """The fault: on CUDA, ``index_add_`` adds with atomics, so its sums
    are only close to the CPU's event-ordered ones. The repair: on CUDA
    ``partial_spend_sums`` is the event-ordered kernel, bitwise the CPU.
    8 campaigns, 32 blocks of ~2,400 rows: ~300 rows per (block, campaign)."""
    n, c = 76_800, 8
    winners, prices = _log(1, n, c, seed=5)
    weights = (torch.arange(n) % 7 != 3).to(torch.float32)
    block = -(-n // G)
    on_cpu = segments.partial_spend_sums(winners[0], prices[0], c, weights,
                                         block_size=block)
    before = cuda_sp.LAUNCHES["segment_partials"]
    on_card = segments.partial_spend_sums(
        winners[0].to(dev), prices[0].to(dev), c, weights.to(dev),
        block_size=block)
    torch.cuda.synchronize()
    assert cuda_sp.LAUNCHES["segment_partials"] == before + 1
    assert torch.equal(on_card.cpu(), on_cpu)
    atomics = segments.index_add_partials(
        winners[0].to(dev), (prices[0] * weights).to(dev), c,
        block_size=block)
    torch.testing.assert_close(atomics.cpu(), on_cpu, rtol=1e-5, atol=0.0)


def test_window_partials_on_the_card_gives_the_cpu_bits(dev):
    """S lanes, a window per lane, a slice of the log at an offset, and C
    above one warp's width."""
    s, n_global, c = 5, 9000, 70
    offset, n = 1500, 6000
    winners, prices = _log(s, n, c, seed=6)
    lo = torch.tensor([0, 1000, 2500, 4000, 7400], dtype=torch.int32)
    hi = torch.tensor([9000, 5000, 2600, 8000, 7400], dtype=torch.int32)
    block = -(-n_global // G)
    on_cpu = segments.window_partials(winners, prices, c, lo, hi,
                                      block_size=block, index_offset=offset)
    on_card = segments.window_partials(
        winners.to(dev), prices.to(dev), c, lo.to(dev), hi.to(dev),
        block_size=block, index_offset=offset)
    assert torch.equal(on_card.cpu(), on_cpu)


# ---------------------------------------------------------------------------
# sweep_resolve and capped_scan against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("per_event", [False, True])
@pytest.mark.parametrize("n,c", [(3000, 37), (1111, 150)])
def test_sweep_resolve_matches_plain(dev, sp, per_event, n, c):
    s = 6
    x = _inputs(s, n, c, seed=7)
    act = x["act"]
    if per_event:
        rng = np.random.default_rng(8)
        act = torch.from_numpy(rng.uniform(size=(s, n, c)) < 0.7)
    args = (x["values"], x["mult"], act, x["res"])
    on_cpu = ops.sweep_resolve(*args, second_price=sp)
    before = cuda_sr.LAUNCHES["sweep_resolve"]
    on_card = ops.sweep_resolve(*[a.to(dev) for a in args], second_price=sp)
    torch.cuda.synchronize()
    assert cuda_sr.LAUNCHES["sweep_resolve"] == before + 1
    for a, b in zip(on_card, on_cpu):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


def _scan_inputs(s, n, c, seed):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 1.0, (n, c)).astype(np.float32)
    mult = rng.uniform(0.5, 1.5, (s, c)).astype(np.float32)
    mult[:, 1] = 0.0                               # a campaign that never bids
    budgets = rng.uniform(0.5, 8.0, (s, c)).astype(np.float32)
    budgets[:, 2] = 0.0                            # caps at event 1, unsold
    reserves = np.linspace(0.0, 0.3, s).astype(np.float32)
    return [torch.from_numpy(a) for a in (values, budgets, mult, reserves)]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("c", [20, 64, 100, 256])
def test_capped_scan_matches_plain(dev, sp, c):
    values, budgets, mult, reserves = _scan_inputs(4, 3000, c, seed=9)
    on_cpu = scan_ops.capped_scan(values, budgets, mult, reserves,
                                  second_price=sp)
    before = cuda_cs.LAUNCHES["capped_scan"]
    on_card = scan_ops.capped_scan(values.to(dev), budgets.to(dev),
                                   mult.to(dev), reserves.to(dev),
                                   second_price=sp)
    torch.cuda.synchronize()
    assert cuda_cs.LAUNCHES["capped_scan"] == before + 1
    for a, b in zip(on_card, on_cpu):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)
    assert bool((on_cpu[3][:, 2] == 1).all())      # zero budget caps first


def test_oracle_entry_points_on_the_card(dev):
    """``sequential_replay`` and ``sweep_sequential`` on CUDA tensors run
    the kernel and give the CPU plain loop's bits."""
    env = make_synthetic_env(2, n_events=2048, n_campaigns=12, emb_dim=6,
                             device="cpu")
    rules = AuctionRule(multipliers=torch.stack([env.rule.multipliers,
                                                 env.rule.multipliers * 1.2]),
                        reserve=torch.tensor([0.0, 0.05]),
                        kind="second_price")
    budgets = torch.stack([env.budgets, env.budgets * 0.5])
    on_cpu = sweep_sequential(env.values, budgets, rules, record_events=True)
    on_card = sweep_sequential(
        env.values.to(dev), budgets.to(dev),
        AuctionRule(multipliers=rules.multipliers.to(dev),
                    reserve=rules.reserve.to(dev), kind=rules.kind),
        record_events=True)
    for name in ("final_spend", "cap_times", "winners", "prices"):
        assert torch.equal(getattr(on_card, name).cpu(),
                           getattr(on_cpu, name)), name
    lane = AuctionRule(multipliers=rules.multipliers[1],
                       reserve=rules.reserve[1], kind=rules.kind)
    solo = sequential_replay(env.values, budgets[1], lane)
    assert torch.equal(solo.final_spend, on_cpu.final_spend[1])
    assert torch.equal(solo.cap_times, on_cpu.cap_times[1])


# ---------------------------------------------------------------------------
# Every back-end and driver on the card gives the CPU's bits
# ---------------------------------------------------------------------------

def _grid_env():
    env = make_synthetic_env(4, n_events=4096, n_campaigns=16, emb_dim=8,
                             device="cpu")
    budgets = torch.stack([env.budgets, env.budgets * 0.5, env.budgets * 2])
    rules = AuctionRule(
        multipliers=torch.stack([env.rule.multipliers * m
                                 for m in (1.0, 1.2, 0.9)]),
        reserve=torch.tensor([0.0, 0.05, 0.0]), kind="first_price")
    return env, budgets, rules


def _on(dev, rules):
    return AuctionRule(multipliers=rules.multipliers.to(dev),
                       reserve=rules.reserve.to(dev), kind=rules.kind)


@pytest.mark.parametrize("resolve", ["torch", "sweep_resolve", "fused"])
def test_every_backend_on_the_card_is_the_cpu_sweep(dev, resolve):
    env, budgets, rules = _grid_env()
    on_cpu = sweep_state_machine(env.values, budgets, rules, resolve="torch")
    cuda_sp.reset_launches()
    cuda_sr.reset_launches()
    on_card = sweep_state_machine(env.values.to(dev), budgets.to(dev),
                                  _on(dev, rules), resolve=resolve)
    rounds = int(on_card[4].max())
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    want_sp = 0 if resolve == "fused" else 2 * rounds
    want_sr = rounds if resolve == "sweep_resolve" else 0
    assert cuda_sp.LAUNCHES["segment_partials"] == want_sp
    assert cuda_sr.LAUNCHES["sweep_resolve"] == want_sr


@pytest.mark.parametrize("driver,resolve", [
    ("device", "torch"), ("device", "sweep_resolve"), ("device", "fused"),
    ("host", "torch")])
def test_parallel_simulate_on_the_card_is_the_cpu_result(dev, driver,
                                                         resolve):
    env, budgets, rules = _grid_env()
    rule = AuctionRule(multipliers=rules.multipliers[1],
                       reserve=rules.reserve[1], kind=rules.kind)
    kw = dict(driver=driver, resolve=resolve, return_trace=True)
    res_cpu, trace_cpu = parallel_simulate(env.values, budgets[1], rule,
                                           **kw)
    res, trace = parallel_simulate(
        env.values.to(dev), budgets[1].to(dev),
        AuctionRule(multipliers=rule.multipliers.to(dev),
                    reserve=rule.reserve.to(dev), kind=rule.kind), **kw)
    assert torch.equal(res.final_spend.cpu(), res_cpu.final_spend)
    assert torch.equal(res.cap_times.cpu(), res_cpu.cap_times)
    assert torch.equal(res.segments.boundaries.cpu(),
                       res_cpu.segments.boundaries)
    assert torch.equal(res.segments.masks.cpu(), res_cpu.segments.masks)
    assert trace == trace_cpu


# ---------------------------------------------------------------------------
# auction_resolve and first_crossing (SORT2AGGREGATE) against their plain
# versions, and the slice end to end
# ---------------------------------------------------------------------------

def _emb(n, c, d, per_event, seed):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return (t(rng.standard_normal((n, d)).astype(np.float32)),
            t(rng.standard_normal((c, d)).astype(np.float32)),
            t(np.exp(rng.standard_normal(c) * 0.1).astype(np.float32)),
            t(rng.uniform(size=(n, c) if per_event else (c,)) < 0.8))


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("per_event", [False, True])
@pytest.mark.parametrize("n,c,d", [(3000, 37, 10), (1111, 150, 3),
                                   (777, 5, 128)])
def test_auction_resolve_emb_tile_matches_plain(dev, sp, per_event, n, c, d):
    """EmbTile: winners and prices are the plain version's bits on the card
    (the same expf and division); the event-ordered sums are the plain
    version's up to the atomics of its index_add_."""
    e, r, mult, act = [x.to(dev) for x in _emb(n, c, d, per_event, 9)]
    res = torch.tensor(0.03, device=dev)
    before = cuda_ar.LAUNCHES["auction_resolve"]
    got = ops.auction_resolve(e, r, mult, act, res, second_price=sp)
    want = ref.auction_resolve_ref(e, r, mult, act, res, second_price=sp)
    torch.cuda.synchronize()
    assert cuda_ar.LAUNCHES["auction_resolve"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    bf = ops.auction_resolve(e.bfloat16(), r.bfloat16(), mult, act, res,
                             second_price=sp)
    bf_want = ref.auction_resolve_ref(e.bfloat16(), r.bfloat16(), mult, act,
                                      res, second_price=sp)
    assert torch.equal(bf[0], bf_want[0]) and torch.equal(bf[1], bf_want[1])


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("per_event", [False, True])
@pytest.mark.parametrize("n,c", [(3000, 37), (1111, 150), (64, 100)])
def test_resolve_masked_matrix_tile_is_the_cpu(dev, sp, per_event, n, c):
    """MatrixTile with dead rows: winners, prices and the event-ordered sums
    are the plain version's bits on the CPU."""
    rng = np.random.default_rng(n + c)
    values = torch.from_numpy(rng.uniform(0, 1, (n, c)).astype(np.float32))
    mult = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    act = torch.from_numpy(rng.uniform(size=(n, c) if per_event else (c,))
                           < 0.7)
    live = torch.from_numpy(rng.uniform(size=n) < 0.9)
    res = torch.tensor(0.05)
    on_cpu = ops.resolve_masked(values, mult, act, res, live,
                                second_price=sp)
    on_card = ops.resolve_masked(values.to(dev), mult.to(dev), act.to(dev),
                                 res.to(dev), live.to(dev), second_price=sp)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    no_sums = ops.resolve_masked(values.to(dev), mult.to(dev), act.to(dev),
                                 res.to(dev), second_price=sp, sums=False)
    assert no_sums[2] is None


def test_auction_resolve_refuses_what_its_shared_memory_cannot_hold(dev):
    e, r, mult, act = [x.to(dev) for x in _emb(16, 4000, 16, False, 1)]
    with pytest.raises(ValueError, match="C·d"):
        ops.auction_resolve(e, r, mult, act)


def _crossing_log(s, n, c, block, seed):
    """S lanes of resolved events and budgets at the plain version's own
    running spend at random events, some one ulp above it."""
    winners, prices = _log(s, n, c, seed)
    rng = np.random.default_rng(seed)
    budgets = torch.empty((s, c))
    for lane in range(s):
        cum, s0 = [], torch.zeros(c)
        for lo in range(0, n, block):
            sm = (winners[lane, lo:lo + block, None] == torch.arange(c)) \
                * prices[lane, lo:lo + block, None]
            cum.append(s0 + segments.xla_cumsum(sm))
            s0 = cum[-1][-1]
        cum = torch.cat(cum)
        rows = torch.from_numpy(rng.integers(0, n, c))
        budgets[lane] = cum[rows, torch.arange(c)]
    budgets[:, ::2] = torch.nextafter(budgets[:, ::2],
                                      torch.tensor(float("inf")))
    return winners, prices, budgets


@pytest.mark.parametrize("block", [4096, 1000, 17, 16, 65536])
@pytest.mark.parametrize("c", [12, 150])
def test_first_crossing_is_the_cpu(dev, block, c):
    s, n = 3, 20_000
    winners, prices, budgets = _crossing_log(s, n, c, block, seed=block + c)
    want_spend, want_cap = segments.crossing_and_spend(winners, prices,
                                                       budgets, c, block)
    before = cuda_fc.LAUNCHES["first_crossing"]
    spend, cap = segments.crossing_and_spend(
        winners.to(dev), prices.to(dev), budgets.to(dev), c, block)
    torch.cuda.synchronize()
    assert cuda_fc.LAUNCHES["first_crossing"] == before + 1
    assert torch.equal(cap.cpu(), want_cap)
    assert torch.equal(spend.cpu(), want_spend)
    assert bool((want_cap <= n).any())


def test_spend_sums_on_the_card_is_the_cpu_sum():
    """The repair of index_add_'s atomics: on CUDA, auction.spend_sums is
    the event-ordered flat sum, bitwise the CPU's at N=1e6, C=100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    winners, prices = _log(1, 1_000_000, 100, seed=11)
    weights = (torch.arange(1_000_000) % 5 != 2).to(torch.float32)
    on_cpu = auction.spend_sums(winners[0], prices[0], 100, weights)
    on_card = auction.spend_sums(winners[0].cuda(), prices[0].cuda(), 100,
                                 weights.cuda())
    assert torch.equal(on_card.cpu(), on_cpu)


def test_sort2aggregate_on_the_card_is_the_cpu(dev):
    """engine.simulate() (Algorithm 4, refinement, aggregate) and the S2A
    sweep in every warm-start mode: the card's bits are the CPU's."""
    env, budgets, rules = _grid_env()
    grid_axes = dict(bid_scales=[1.0, 1.2], reserves=[0.0, 0.05])
    on = {}
    for device in ("cpu", dev):
        engine = CounterfactualEngine(env.values, env.budgets,
                                      device=device)
        grid = engine.grid(**grid_axes)
        cuda_ar.reset_launches()
        cuda_fc.reset_launches()
        on[str(device)] = [engine.simulate(),
                           engine.simulate(key=prng.PRNGKey(3),
                                           vi_batch_size=1, vi_iters=2)] + [
            engine.sweep(grid, method="sort2aggregate", warm_start=w,
                         refine_iters=3).results
            for w in ("base", "per_scenario", False)]
    assert cuda_ar.LAUNCHES["auction_resolve"] > 0
    assert cuda_fc.LAUNCHES["first_crossing"] > 0
    for a, b in zip(on[str(dev)], on["cpu"]):
        assert torch.equal(a.final_spend.cpu(), b.final_spend)
        assert torch.equal(a.cap_times.cpu(), b.cap_times)
