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
                              Segments, auction, executor, parallel_simulate,
                              segments, sequential_replay, sweep_sequential,
                              sweep_sort2aggregate, sweep_state_machine, vi)
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
    segment_resolve as cuda_sg  # noqa: E402
from repro_torch.kernels.auction_resolve import vi as cuda_vi  # noqa: E402
from repro_torch.kernels.auction_resolve import \
    sweep_resolve as cuda_sr  # noqa: E402
from repro_torch.kernels.capped_scan import capped_scan as cuda_cs  # noqa: E402
from repro_torch.kernels.capped_scan import ops as scan_ops  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as cuda_fab  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import attention as t_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

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
# The redesigned resolve core (csrc/lane_resolve.cuh) at its edges
# ---------------------------------------------------------------------------

def _coarse(s, n, c, seed, per_event=False):
    """Valuations and multipliers on coarse grids (many equal bids, so ties
    for the first index to break are common) and an activation."""
    rng = np.random.default_rng(seed)
    values = (rng.integers(0, 8, (n, c)) / 8).astype(np.float32)
    mult = rng.choice(np.float32([0.5, 1.0, 1.5]), (s, c))
    act = rng.uniform(size=(s, n, c) if per_event else (s, c)) < 0.8
    res = (np.arange(s) % 4 / 8).astype(np.float32)
    return [torch.from_numpy(x) for x in (values, mult, act, res)]


def _lanes8_threshold():
    """The largest C whose work items still take 8 lanes."""
    c = 1
    while cuda_rf.item_lanes(c + 1) == 8:
        c += 1
    return c


# name: (S, N, C, windows); C "t8" / "t8+1" is the largest C an item of 8
# lanes holds and one more (items of 4). windows: "mid_tile" (across blocks,
# starting and ending inside 256-row tiles), "one_block" (inside canonical
# block 20), "block_edges" (n_next on a block edge), "retired_offset" (a
# slice of the log at offset 1000, every third lane dead)
PARTIALS_EDGES = {
    "mid_tile": (6, 20_000, 37, "mid_tile"),
    "one_block": (5, 20_000, 100, "one_block"),
    "block_edges": (4, 20_000, 100, "block_edges"),
    "retired_offset_s7": (7, 20_000, 129, "retired_offset"),
    "c1": (9, 5_000, 1, "mid_tile"),
    "c100": (32, 8_000, 100, "mid_tile"),
    "c129": (3, 5_000, 129, "retired_offset"),
    "c_t8": (8, 3_000, "t8", "mid_tile"),
    "c_t8+1": (8, 3_000, "t8+1", "mid_tile"),
}


def _edge_windows(kind, s, n):
    block = -(-n // G)
    ar = torch.arange(s, dtype=torch.int64)
    alive = torch.ones(s, dtype=torch.bool)
    offset, n_local = 0, n
    if kind == "mid_tile":
        lo = 37 + ar * (n // (3 * s)) + 101 * (ar % 3)
        hi = n - 5 - ar * (n // (4 * s)) - 77 * (ar % 2)
    elif kind == "one_block":
        lo = 20 * block + 3 + ar * 7
        hi = 21 * block - 1 - ar * 5
    elif kind == "block_edges":
        lo = (ar + 1) * block
        hi = torch.minimum((ar + 3) * block, torch.tensor(n))
    else:
        offset, n_local = 1000, n - 3000
        lo = 900 + ar * 333
        hi = n - 2500 - ar * 251
        alive = ar % 3 != 1
    return (lo.to(torch.int32), hi.to(torch.int32), alive, offset, n_local,
            block)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("case", sorted(PARTIALS_EDGES))
def test_partials_kernel_edges_give_the_cpu_bits(dev, case, sp):
    """partials_kernel at the redesign's edges (windows starting and ending
    inside a tile, inside one canonical block, on block edges, retired
    lanes, an offset slice, S no multiple of the lanes per item, C of 1,
    100, 129 and either side of the 8-lane item's shared memory): the CPU's
    fused_partials_ref bit for bit, retired lanes zero."""
    s, n, c, kind = PARTIALS_EDGES[case]
    if isinstance(c, str):
        c = _lanes8_threshold() + (1 if c.endswith("+1") else 0)
    values, mult, act, res = _coarse(s, n, c, seed=len(case))
    lo, hi, alive, offset, n_local, block = _edge_windows(kind, s, n)
    v_local = values[offset:offset + n_local]
    before = cuda_rf.LAUNCHES["sweep_partials"]
    got = ops.sweep_partials(
        v_local.to(dev), mult.to(dev), act.to(dev), res.to(dev), lo.to(dev),
        hi.to(dev), alive.to(dev), offset, n_events_global=n,
        reduce_blocks=G, second_price=sp)
    torch.cuda.synchronize()
    assert cuda_rf.LAUNCHES["sweep_partials"] == before + 1
    want = ref.fused_partials_ref(v_local, mult, act, res, lo, hi,
                                  block_size=block, second_price=sp,
                                  index_offset=offset)
    got = got.cpu()
    assert torch.equal(got[alive], want[alive])
    assert not got[~alive].any()
    assert got[alive].any()


# name: (S, N, C, per-event mask)
SWEEP_RESOLVE_EDGES = {
    "rows_below_a_tile": (3, 100, 37, False),
    "ragged_n_s5": (5, 1_001, 100, False),
    "c1": (9, 3_000, 1, False),
    "c129_per_event": (4, 2_000, 129, True),
    "c_t8": (8, 1_500, "t8", False),
    "c_t8+1": (8, 1_500, "t8+1", False),
}


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("case", sorted(SWEEP_RESOLVE_EDGES))
def test_sweep_resolve_kernel_edges_give_the_cpu_bits(dev, case, sp):
    """sweep_resolve_kernel at the redesign's edges: winners, prices and the
    folded sums are the CPU's sweep_resolve_ref bit for bit."""
    s, n, c, per_event = SWEEP_RESOLVE_EDGES[case]
    if isinstance(c, str):
        c = _lanes8_threshold() + (1 if c.endswith("+1") else 0)
    values, mult, act, res = _coarse(s, n, c, seed=len(case),
                                     per_event=per_event)
    got = ops.sweep_resolve(values.to(dev), mult.to(dev), act.to(dev),
                            res.to(dev), second_price=sp)
    want = ref.sweep_resolve_ref(values, mult, act, res, second_price=sp)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kernel", ["partials", "sweep_resolve"])
def test_round_kernels_at_their_campaign_limits(dev, kernel):
    """At the kernels' own limit (a one-lane item's shared memory) the
    results are the CPU's bits; one campaign more, the wrapper refuses."""
    limit = ops.round_campaign_limits()[
        "fused" if kernel == "partials" else "sweep_resolve"]
    s, n = 3, 300
    values, mult, act, res = _coarse(s, n, limit, seed=21)
    block = -(-n // G)
    if kernel == "partials":
        lo = torch.tensor([0, 17, 150], dtype=torch.int32)
        hi = torch.tensor([300, 290, 151], dtype=torch.int32)
        alive = torch.ones(s, dtype=torch.bool)

        def run(v, m, a, r):
            return ops.sweep_partials(
                v, m, a, r, lo.to(v.device), hi.to(v.device),
                alive.to(v.device), n_events_global=n, reduce_blocks=G,
                second_price=True)

        got = run(values.to(dev), mult.to(dev), act.to(dev), res.to(dev))
        want = ref.fused_partials_ref(values, mult, act, res, lo, hi,
                                      block_size=block, second_price=True)
        assert torch.equal(got.cpu(), want)
    else:
        def run(v, m, a, r):
            return ops.sweep_resolve(v, m, a, r, second_price=True)

        got = run(values.to(dev), mult.to(dev), act.to(dev), res.to(dev))
        want = ref.sweep_resolve_ref(values, mult, act, res,
                                     second_price=True)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    wide = [torch.cat([x, x[..., :1]], dim=-1).to(dev)
            for x in (values, mult, act)]
    with pytest.raises(ValueError, match="exceeds"):
        run(*wide, res.to(dev))


def test_parallel_sweep_at_the_first_designs_limit_plus_one(dev):
    """C = 12,269, one past the first partials kernel's shared memory: the
    fused round takes it now (no auction_resolve launch) with the CPU's
    bits."""
    c = 12_269
    assert ops.round_campaign_limits()["fused"] >= c
    out = {}
    for device in ("cpu", dev):
        engine = _wide_engine(c, device, seed=5)
        grid = engine.grid(bid_scales=[1.0, 1.2], reserves=[0.0, 0.05])
        for mod in (cuda_rf, cuda_ar):
            mod.reset_launches()
        out[str(device)] = engine.sweep(grid, method="parallel").results
    assert cuda_rf.LAUNCHES["round_fused"] > 0
    assert cuda_ar.LAUNCHES["auction_resolve"] == 0
    for name in ("final_spend", "cap_times"):
        assert torch.equal(getattr(out[str(dev)], name).cpu(),
                           getattr(out["cpu"], name)), name


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


SP_LAYOUTS = {   # n_global, offset, n, lanes' global windows [lo, hi)
    # n not a multiple of the 512-row chunk, windows whose edges fall
    # inside a chunk, an empty window
    "whole": (20_000, 0, 20_000, [0, 777, 5000], [20_000, 13_001, 5000]),
    # a slice at an odd offset: lanes of 11,111 rows start off a 16-byte
    # boundary; one window of a single row, one empty at the slice's end
    "slice": (15_000, 1537, 11_111, [0, 2000, 9000, 14_000],
              [15_000, 2001, 12_647, 14_000]),
}


@pytest.mark.parametrize("layout", sorted(SP_LAYOUTS))
@pytest.mark.parametrize("c", [1, 33, "limit"])
def test_segment_partials_edges_give_the_cpu_bits(dev, layout, c):
    """The staged kernel at its edges, bitwise ``window_partials_ref``
    (``index_add_`` on the CPU): C from 1 to the kernel's shared-memory
    limit (``sp_max_campaigns``), window edges inside a staged chunk, an
    offset, an empty window, and n not a multiple of the chunk."""
    if c == "limit":
        c = cuda_sp._lib().sp_max_campaigns()
    n_global, offset, n, lo, hi = SP_LAYOUTS[layout]
    winners, prices = _log(len(lo), n, c, seed=n + c % 101)
    lo = torch.tensor(lo, dtype=torch.int32)
    hi = torch.tensor(hi, dtype=torch.int32)
    block = -(-n_global // G)
    on_cpu = segments.window_partials_ref(winners, prices, c, lo, hi,
                                          block_size=block,
                                          index_offset=offset)
    before = cuda_sp.LAUNCHES["segment_partials"]
    on_card = segments.window_partials(
        winners.to(dev), prices.to(dev), c, lo.to(dev), hi.to(dev),
        block_size=block, index_offset=offset)
    torch.cuda.synchronize()
    assert cuda_sp.LAUNCHES["segment_partials"] == before + 1
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


def _scan_edges(n, c, seed, second_price):
    """The windowed kernel's traps: tied valuations (four levels), a lane
    with a negative reserve and rows of zero valuations (zero bids that are
    eligible), a NaN budget, budgets small enough that most campaigns cap,
    and a lane where campaign 0 alone bids 1.0 an event against the spend
    of 1,024 sales, so it caps on the first window's last event and every
    later window of that lane sells nothing."""
    values, budgets, mult, reserves = _scan_inputs(4, n, c, seed)
    rng = np.random.default_rng(seed + 1)
    values = torch.from_numpy(
        rng.integers(0, 4, (n, c)).astype(np.float32) / 4)
    values[::7] = 0.0
    values[:, 0] = 1.0
    budgets = budgets * 0.3
    budgets[0, 4] = float("nan")
    reserves[1] = -0.25
    mult[3] = 0.0
    mult[3, 0] = 1.0
    price = reserves[3].numpy() if second_price else np.float32(1.0)
    acc = np.float32(0.0)
    for _ in range(1024):
        acc = np.float32(acc + price)
    budgets[3, 0] = float(acc)
    return values, budgets, mult, reserves


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("c,layout", [(20, "plain"), (64, "plain"),
                                      (100, "plain"), (256, "plain"),
                                      (257, "plain"), (1000, "plain"),
                                      (37, "edges"), (300, "edges")])
def test_capped_scan_matches_plain(dev, sp, c, layout):
    """Bitwise the plain version at C up to and past the first design's
    256-campaign limit, and at the windowed design's edges: N not a
    multiple of the 1,024-event window, ties, zero bids under a negative
    reserve, zero and NaN budgets, a cap on a window's last event and
    windows without a sale. Shared-memory state beyond
    cs_max_shared_campaigns() is test_capped_scan_state_in_device_memory."""
    n = 3000 if layout == "plain" else 2 * 1024 + 37
    values, budgets, mult, reserves = (
        _scan_inputs(4, n, c, seed=9) if layout == "plain"
        else _scan_edges(n, c, seed=c, second_price=sp))
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
    if layout == "edges":
        assert int(on_cpu[3][3, 0]) == 1024        # the window's last event
        assert int(on_cpu[3][0, 4]) == n + 1       # a NaN budget never caps
        assert bool((on_cpu[3] <= n).float().mean() > 0.5)


def test_capped_scan_state_in_device_memory(dev):
    """C above cs_max_shared_campaigns(): the lane state lives in device
    memory, and the bits are the plain version's."""
    c = cuda_cs._lib().cs_max_shared_campaigns() + 1
    values, budgets, mult, reserves = _scan_inputs(2, 300, c, seed=12)
    budgets = budgets * 0.05
    on_cpu = scan_ops.capped_scan(values, budgets, mult, reserves,
                                  second_price=True)
    on_card = scan_ops.capped_scan(values.to(dev), budgets.to(dev),
                                   mult.to(dev), reserves.to(dev),
                                   second_price=True)
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)
    assert bool((on_cpu[3] <= 300).any())


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

def _wide_engine(c, device, seed):
    """An engine of C campaigns over 512 events, budgets large but for ten
    campaigns that value the events most and cap, so Algorithm 2 runs a
    few rounds at any C."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 1.0, (512, c)).astype(np.float32)
    budgets = np.full(c, 1e6, np.float32)
    budgets[:10] = 5.0
    values[:, :10] += 0.5
    return CounterfactualEngine(torch.from_numpy(values),
                                torch.from_numpy(budgets), device=device)


@pytest.mark.parametrize("c", [257, 1000])
def test_sequential_sweep_above_the_first_kernels_limit(dev, c):
    """engine.sweep(method="sequential") at C past the first capped-scan
    design's 256: one launch, the CPU's bits, both rules."""
    for kind in ("first_price", "second_price"):
        out = {}
        for device in ("cpu", dev):
            engine = _wide_engine(c, device, seed=c)
            engine.base_rule = AuctionRule(
                multipliers=engine.base_rule.multipliers,
                reserve=engine.base_rule.reserve, kind=kind)
            grid = engine.grid(bid_scales=[1.0, 1.2], reserves=[0.0, 0.05],
                               budget_scales=[1.0, 0.02])
            cuda_cs.reset_launches()
            out[str(device)] = engine.sweep(grid, method="sequential",
                                            record_events=True).results
            assert cuda_cs.LAUNCHES["capped_scan"] == (device == dev)
        for name in ("final_spend", "cap_times", "winners", "prices"):
            assert torch.equal(getattr(out[str(dev)], name).cpu(),
                               getattr(out["cpu"], name)), (kind, name)
        assert bool((out["cpu"].cap_times <= 512).any())


@pytest.mark.parametrize("resolve", ["auto", "fused", "sweep_resolve"])
def test_parallel_sweep_above_the_round_kernels_limits(dev, resolve,
                                                       monkeypatch):
    """engine.sweep(method="parallel") at a C the fused round (or the
    sweep_resolve kernel) cannot hold: every lane of a round is resolved by
    one auction_resolve launch (and one merge of its campaign chunks) and
    the partials by segment_partials (the counters show them, one resolve
    a round, and neither round kernel), and the results are the CPU torch
    path's bits."""
    limits = ops.round_campaign_limits()
    c = limits["fused" if resolve == "auto" else resolve] + 1
    rounds = []
    lanes = executor.resolve_ops.resolve_lanes

    def one_round(values, multipliers, active, *args, **kw):
        rounds.append(tuple(active.shape))
        return lanes(values, multipliers, active, *args, **kw)

    monkeypatch.setattr(executor.resolve_ops, "resolve_lanes", one_round)
    out = {}
    for device in ("cpu", dev):
        engine = _wide_engine(c, device, seed=5)
        grid = engine.grid(bid_scales=[1.0, 1.2], reserves=[0.0, 0.05])
        for mod in (cuda_rf, cuda_sr, cuda_sp, cuda_ar):
            mod.reset_launches()
        rounds.clear()
        out[str(device)] = engine.sweep(grid, method="parallel",
                                        resolve=resolve).results
    assert executor.pick_resolve(resolve, dev, c) == executor.ANY_C_BACKEND
    assert cuda_rf.LAUNCHES["round_fused"] == 0
    assert cuda_rf.LAUNCHES["sweep_partials"] == 0
    assert cuda_sr.LAUNCHES["sweep_resolve"] == 0
    assert rounds and set(rounds) == {(4, c)}
    assert cuda_ar.LAUNCHES["auction_resolve"] == len(rounds)
    assert cuda_ar.LAUNCHES["auction_resolve_merge"] == len(rounds)
    assert cuda_sp.LAUNCHES["segment_partials"] > 0
    for name in ("final_spend", "cap_times"):
        assert torch.equal(getattr(out[str(dev)], name).cpu(),
                           getattr(out["cpu"], name)), name
    assert bool((out["cpu"].cap_times <= 512).any())

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


def _lane_matrix(s, n, c, seed):
    """S lanes of an (N, C) matrix whose bids tie (values in eighths,
    multipliers in {0.5, 1, 1.5}), inactive campaigns, rows no campaign
    bids on and, for S > 3, a lane whose reserve is above every bid."""
    rng = np.random.default_rng(seed)
    values = (rng.integers(0, 8, (n, c)) / 8).astype(np.float32)
    values[::17] = 0.0
    mult = rng.choice(np.float32([0.5, 1.0, 1.5]), (s, c))
    act = rng.uniform(size=(s, c)) < 0.7
    res = (np.arange(s) % 4 / 8).astype(np.float32)
    if s > 3:
        res[3] = 10.0
    return (torch.from_numpy(values), torch.from_numpy(mult),
            torch.from_numpy(act), torch.from_numpy(res))


LANE_SHAPES = [   # s, n, c: the any-C back-end's shape and the layouts
    (4, 512, 15_553),      # C = 1 (mod 4): 66 campaign chunks
    (1, 512, 15_553),
    (32, 700, 4_099),      # C = 3 (mod 4), 4 slots of 8 lanes
    (37, 300, 1_000),      # C = 0 (mod 4), two passes of 32 lanes
    (3, 40_000, 130),      # C = 2 (mod 4), one chunk
    (5, 1, 64),
    (2, 129, 1),
]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("s,n,c", LANE_SHAPES)
def test_resolve_lanes_is_the_cpu(dev, sp, s, n, c):
    """The matrix kernel resolves every lane in one launch (one merge when
    the columns go to several chunks): winners and prices bitwise the
    plain version on the CPU, two launches bitwise equal."""
    values, mult, act, res = _lane_matrix(s, n, c, seed=s + n + c)
    want = ref.resolve_lanes_ref(values, mult, act, res, sp)
    chunks, _ = cuda_ar.chunk_plan(
        n, c, torch.cuda.get_device_properties(dev).multi_processor_count)
    cuda_ar.reset_launches()
    got = ops.resolve_lanes(values.to(dev), mult.to(dev), act.to(dev),
                            res.to(dev), second_price=sp)
    again = ops.resolve_lanes(values.to(dev), mult.to(dev), act.to(dev),
                              res.to(dev), second_price=sp)
    torch.cuda.synchronize()
    assert cuda_ar.LAUNCHES == {"auction_resolve": 2,
                                "auction_resolve_merge": 2 * (chunks > 1)}
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a.cpu(), w)


@pytest.mark.parametrize("sp", [False, True])
def test_resolve_chunks_and_merge_are_the_cpu(dev, sp):
    """The two launches apart at the any-C back-end's shape: the resolve's
    per-chunk (best, second, win) bitwise ``ref.resolve_chunks_ref`` on
    the CPU at the card's chunk plan, and the merge of those bitwise
    ``ref.merge_chunks_ref``."""
    values, mult, act, res = _lane_matrix(4, 512, 15_553, seed=2)
    chunks, cols = cuda_ar.chunk_plan(
        512, 15_553, torch.cuda.get_device_properties(dev).multi_processor_count)
    assert chunks > 1
    parts = cuda_ar.resolve_chunks_cuda(values.to(dev), mult.to(dev),
                                        act.to(dev), res.to(dev),
                                        second_price=sp)
    want = ref.resolve_chunks_ref(values, mult, act, res, chunk_cols=cols)
    for a, b in zip(parts, want):
        assert torch.equal(a.cpu(), b)
    merged = cuda_ar.merge_chunks_cuda(*parts, second_price=sp)
    for a, b in zip(merged, ref.merge_chunks_ref(*want, sp)):
        assert torch.equal(a.cpu(), b)


def test_resolve_lanes_refuses_an_unaligned_matrix(dev):
    """The matrix kernel copies 16 bytes at a time: a valuation matrix that
    starts off a 16-byte boundary (and, for one lane, an (N, C) mask off a
    4-byte one) is refused, as the flash-attention wrapper refuses such a
    tensor, and nothing is launched or copied."""
    values, mult, act, res = _lane_matrix(3, 257, 99, seed=1)
    flat = torch.zeros(257 * 99 + 1, device=dev)
    shifted = flat[1:].view(257, 99)
    shifted.copy_(values.to(dev))
    cuda_ar.reset_launches()
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.resolve_lanes(shifted, mult.to(dev), act.to(dev), res.to(dev))
    mask = torch.ones(257 * 99 + 1, dtype=torch.bool, device=dev)[1:].view(
        257, 99)
    with pytest.raises(ValueError, match="4-byte boundary"):
        ops.resolve_masked(values.to(dev), mult[0].to(dev), mask,
                           res[0].to(dev))
    assert cuda_ar.LAUNCHES["auction_resolve"] == 0


@pytest.mark.parametrize("sp", [False, True])
def test_auction_resolve_refuses_what_its_shared_memory_cannot_hold(dev, sp):
    """It refuses nothing now: C·d above the kernel's shared memory (C=4000,
    d=16) runs in campaign chunks merged exactly, bitwise the plain version
    on the card, with the flat sums of the merged events bitwise the
    CPU's."""
    e, r, mult, act = [x.to(dev) for x in _emb(16, 4000, 16, False, 1)]
    res = torch.tensor(0.03, device=dev)
    cuda_ar.reset_launches()
    ops.reset_paths()
    got = ops.auction_resolve(e, r, mult, act, res, second_price=sp)
    want = ref.auction_resolve_ref(e, r, mult, act, res, second_price=sp)
    torch.cuda.synchronize()
    assert ops.PATHS["auction_resolve_chunked"] == 1
    assert ops.PATHS["auction_resolve_flat_sums"] == 1
    assert cuda_ar.LAUNCHES["auction_resolve"] > 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].cpu(), auction.spend_sums(
        got[0].cpu(), got[1].cpu(), 4000))


def test_auction_resolve_sums_are_first_crossings_flat_sums(dev):
    """On the card a resolve's sums are first_crossing's flat sum of its
    winners and prices (counted, one a call), at short and long N alike:
    the bits of the plain version's event-ordered sums on the CPU."""
    rng = np.random.default_rng(3)
    for n, c in ((5000, 37), (3000, 150), (700, 100), (1, 3)):
        values = torch.from_numpy(
            rng.uniform(0, 1, (n, c)).astype(np.float32))
        mult = torch.ones(c)
        act = torch.from_numpy(rng.uniform(size=c) < 0.7)
        res = torch.tensor(0.05)
        ops.reset_paths()
        on_card = ops.resolve_masked(values.to(dev), mult.to(dev),
                                     act.to(dev), res.to(dev))
        torch.cuda.synchronize()
        assert ops.PATHS["auction_resolve_flat_sums"] == 1
        on_cpu = ref.resolve_masked_ref(values, mult, act, res)
        for a, b in zip(on_card, on_cpu):
            assert torch.equal(a.cpu(), b)


def test_auction_resolve_sums_above_the_shared_memory(dev):
    """MatrixTile with sums of more C than ``ar_max_shared_floats()``: the
    sums are first_crossing's flat sums, as at every C, and all three
    outputs are the plain version's bits on the CPU."""
    c = cuda_ar.max_shared_floats() + 1
    rng = np.random.default_rng(4)
    n = 256
    values = torch.from_numpy(rng.uniform(0, 1, (n, c)).astype(np.float32))
    mult = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    act = torch.from_numpy(rng.uniform(size=(n, c)) < 0.9)
    res = torch.tensor(0.05)
    on_cpu = ops.resolve_masked(values, mult, act, res, second_price=True)
    cuda_ar.reset_launches()
    cuda_fc.reset_launches()
    ops.reset_paths()
    on_card = ops.resolve_masked(values.to(dev), mult.to(dev), act.to(dev),
                                 res.to(dev), second_price=True)
    torch.cuda.synchronize()
    assert cuda_ar.LAUNCHES["auction_resolve"] == 1
    assert ops.PATHS["auction_resolve_flat_sums"] == 1
    assert cuda_fc.LAUNCHES["first_crossing"] == 1
    for a, b in zip(on_card, on_cpu):
        assert torch.equal(a.cpu(), b)


def test_segment_partials_above_its_shared_memory(dev):
    """C = sp_max_campaigns() + 1: campaign chunks, one launch each,
    bitwise the plain version on the CPU."""
    c = cuda_sp._lib().sp_max_campaigns() + 1
    winners, prices = _log(2, 3000, c, seed=8)
    lo = torch.tensor([0, 700], dtype=torch.int32)
    hi = torch.tensor([3000, 2100], dtype=torch.int32)
    block = -(-3000 // G)
    on_cpu = segments.window_partials_ref(winners, prices, c, lo, hi,
                                          block_size=block)
    cuda_sp.reset_launches()
    on_card = segments.window_partials(
        winners.to(dev), prices.to(dev), c, lo.to(dev), hi.to(dev),
        block_size=block)
    torch.cuda.synchronize()
    assert cuda_sp.LAUNCHES["segment_partials_chunked"] == 1
    assert cuda_sp.LAUNCHES["segment_partials"] == 2
    assert torch.equal(on_card.cpu(), on_cpu)


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


def _crossing_edges(winners, prices, budgets, block, rows=None):
    """Budgets that cross on a block's first and last rows (campaign 1 at
    the running spend of row ``block``, campaign 3 of row ``2 * block -
    1``, each row made a sale of its campaign; rows 0 and N-1 when the log
    holds less than two blocks; or campaigns 1, 3, 5 at ``rows``), a zero
    and a negative budget (cap at event 1), and, with more than one lane, a
    lane without a sale."""
    s, n = winners.shape
    c = budgets.shape[1]
    if rows is None:
        rows = (block, 2 * block - 1) if 2 * block <= n else (0, n - 1)
    for col, row in zip((1, 3, 5), rows):
        for lane in range(s):
            winners[lane, row] = col
            cum, s0 = None, torch.zeros(())
            for lo in range(0, row + 1, block):
                sm = (winners[lane, lo:lo + block] == col) \
                    * prices[lane, lo:lo + block]
                cum = s0 + segments.xla_cumsum(sm[:, None])[:, 0]
                s0 = cum[-1]
            budgets[lane, col] = cum[row % block]
    budgets[:, c - 1] = 0.0
    budgets[:, c - 2] = -1.0
    if s > 1:
        winners[s - 1] = -1
    return winners, prices, budgets


@pytest.mark.parametrize("block", [4096, 1000, 17, 16, 5, 1, 65536, "n"])
@pytest.mark.parametrize("c", [12, 150])
@pytest.mark.parametrize("s,n", [(3, 20_000), (1, 20_000), (3, 700)])
def test_first_crossing_is_the_cpu(dev, block, c, s, n):
    """Cap times and spends bitwise the CPU at every block edge: blocks of
    <= 16 rows (a sequential scan), of 1, and not dividing N, and ``block
    = n`` (20,000 rows: four whole 4,096-row tiles and a ragged one);
    crossings on a block's first and last rows; zero and negative budgets;
    a lane without a sale; one lane (``simulate``'s shape); and a short
    log. A call runs four device kernels, as the library counts them; the
    caps-only call (``first_crossing_times``) three, with the same cap
    times."""
    block = n if block == "n" else block
    winners, prices, budgets = _crossing_log(s, n, c, block, seed=block + c)
    if block > 1:
        winners, prices, budgets = _crossing_edges(winners, prices, budgets,
                                                   block)
    want_spend, want_cap = segments.crossing_and_spend(winners, prices,
                                                       budgets, c, block)
    cuda_fc.reset_launches()
    spend, cap = segments.crossing_and_spend(
        winners.to(dev), prices.to(dev), budgets.to(dev), c, block)
    torch.cuda.synchronize()
    assert cuda_fc.LAUNCHES["first_crossing"] == 1
    assert cuda_fc.LAUNCHES["first_crossing_device_kernels"] == 4
    assert torch.equal(cap.cpu(), want_cap)
    assert torch.equal(spend.cpu(), want_spend)
    assert bool((want_cap <= n).any())
    cuda_fc.reset_launches()
    caps_only = segments.first_crossing_times(
        winners.to(dev), prices.to(dev), budgets.to(dev), c, block)
    torch.cuda.synchronize()
    assert cuda_fc.LAUNCHES["first_crossing_device_kernels"] == 3
    assert torch.equal(caps_only.cpu(), want_cap)


@pytest.mark.parametrize("block", [70_000, 65_536 + 300, 15_625, 4097])
@pytest.mark.parametrize("c", [12, 150])
def test_first_crossing_splits_tiles_is_the_cpu(dev, block, c):
    """Crossing blocks longer than the kernel's 4,096-row tile at N =
    70,000 (``block = n``, the sharded crossing's shape: 17 whole tiles and
    a 368-row one; 65,836: the tiles' totals scanned over XLA's level 4;
    15,625, the chunked S2A sweep's; 4,097: a one-row tile a block), with
    budgets at the plain version's running spend on tile edges (rows 4,095,
    4,096 and 8,191, each a sale of its campaign): cap times,
    spends and the carried running spend bitwise the CPU, with the spends
    and caps only."""
    s, n = 2, 70_000
    winners, prices, budgets = _crossing_log(s, n, c, block, seed=block + c)
    winners, prices, budgets = _crossing_edges(winners, prices, budgets,
                                               block, rows=(4095, 4096, 8191))
    zero = (torch.zeros((s, c)), torch.full((s, c), n + 1,
                                            dtype=torch.int32))
    want_spend, want_cap = segments.crossing_and_spend(winners, prices,
                                                       budgets, c, block)
    want_s0, _ = segments.crossing_carry(winners, prices, budgets, c, block,
                                         s0=zero[0], cap=zero[1], offset=0,
                                         n_global=n)
    args = (winners.to(dev), prices.to(dev), budgets.to(dev))
    for spend_asked in (True, False):
        cuda_fc.reset_launches()
        cap, spend, s0 = cuda_fc.first_crossing_cuda(
            *args, num_campaigns=c, block=block,
            carry=(zero[0].to(dev), zero[1].to(dev), 0, n),
            spend=spend_asked)
        torch.cuda.synchronize()
        assert cuda_fc.LAUNCHES["first_crossing_device_kernels"] == (
            4 if spend_asked else 3)
        assert torch.equal(cap.cpu(), want_cap)
        assert torch.equal(s0.cpu(), want_s0)
        if spend_asked:
            assert torch.equal(spend.cpu(), want_spend)
        else:
            assert spend is None
    assert bool((want_cap <= n).sum() > 2)


@pytest.mark.parametrize("block", [4096, 70_000])
def test_first_crossing_with_negative_prices_is_the_cpu(dev, block):
    """Prices of both signs: the running spend falls as well as rises, so
    the kernel bounds no tile by its last value and walks every campaign
    from a block's first negative price on. Budgets at each campaign's
    highest running spend on the CPU (lane 1 one ulp below): cap times and
    spends bitwise the CPU, with the spends and caps only."""
    s, n, c = 2, 140_000, 12
    rng = np.random.default_rng(block)
    winners = torch.from_numpy(rng.integers(-1, c, (s, n)).astype(np.int32))
    prices = torch.from_numpy(np.where(
        winners.numpy() >= 0, rng.random((s, n)) - 0.55, 0.0).astype(
            np.float32))
    budgets = torch.empty((s, c))
    for lane in range(s):
        best, s0 = None, torch.zeros(c)
        for lo in range(0, n, block):
            sm = (winners[lane, lo:lo + block, None] == torch.arange(c)) \
                * prices[lane, lo:lo + block, None]
            cum = s0 + segments.xla_cumsum(sm)
            top = cum.max(0).values
            best = top if best is None else torch.maximum(best, top)
            s0 = cum[-1]
        budgets[lane] = best
    budgets[1] = torch.nextafter(budgets[1], torch.tensor(-float("inf")))
    want_spend, want_cap = segments.crossing_and_spend(winners, prices,
                                                       budgets, c, block)
    spend, cap = segments.crossing_and_spend(
        winners.to(dev), prices.to(dev), budgets.to(dev), c, block)
    caps_only = segments.first_crossing_times(
        winners.to(dev), prices.to(dev), budgets.to(dev), c, block)
    torch.cuda.synchronize()
    assert torch.equal(cap.cpu(), want_cap)
    assert torch.equal(caps_only.cpu(), want_cap)
    assert torch.equal(spend.cpu(), want_spend)
    assert bool((want_cap <= n).all())


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
        cuda_vi.reset_launches()
        cuda_sg.reset_launches()
        on[str(device)] = [engine.simulate(),
                           engine.simulate(key=prng.PRNGKey(3),
                                           vi_batch_size=1, vi_iters=2)] + [
            engine.sweep(grid, method="sort2aggregate", warm_start=w,
                         refine_iters=3).results
            for w in ("base", "per_scenario", False)]
    # Algorithm 4 one vi launch a run (four simulates: two, the base warm
    # start's, and per_scenario's one for all lanes), each replay pass one
    # segment_resolve launch, no auction_resolve
    assert cuda_vi.LAUNCHES["vi"] == 4
    assert cuda_sg.LAUNCHES["segment_resolve"] == \
        cuda_fc.LAUNCHES["first_crossing"] > 0
    assert cuda_ar.LAUNCHES["auction_resolve"] == 0
    for a, b in zip(on[str(dev)], on["cpu"]):
        assert torch.equal(a.final_spend.cpu(), b.final_spend)
        assert torch.equal(a.cap_times.cpu(), b.cap_times)


# (batch_size, coupling, sample_size, num_iters, C, pi0, track_every): as
# tests/test_torch_vi.py's cases, and simulate's own shape cut in N
VI_CASES = {
    "B64_shared": (64, "shared", 200, 30, 16, None, 3),
    "B64_independent": (64, "independent", 200, 30, 16, None, 0),
    "B1_shared": (1, "shared", 40, 3, 16, None, 7),
    "B20_independent": (20, "independent", 100, 5, 16, None, 0),
    "B3_pi0": (3, "shared", 50, 4, 16, 0.7, 2),
    "B600_independent": (600, "independent", 1500, 2, 16, None, 0),
    "simulate_c100": (64, "shared", 2000, 4, 100, None, 0),
    # the split's edges: fewer steps than the ring's stages; the ring's
    # slots wrapping across epochs of three batches; rows that fill no
    # whole warp (13 rows, 2 a warp; 100 rows, 16 a warp); C=37 (columns,
    # not quads); C=36 (nine quads), W = C; C=1
    "total_below_stages": (64, "shared", 150, 1, 16, None, 1),
    "ring_wraps_epochs": (64, "independent", 150, 7, 16, None, 0),
    "B1_C37": (1, "shared", 30, 2, 37, None, 0),
    "B13_C37": (13, "shared", 100, 3, 37, None, 2),
    "B100_C36_independent": (100, "independent", 300, 3, 36, None, 0),
    "C1_independent": (20, "independent", 120, 3, 1, None, 0),
}


def _vi_env(c, seed=5):
    rng = np.random.default_rng(seed)
    values = torch.from_numpy(rng.uniform(0, 1, (4096, c)).astype(np.float32))
    budgets = torch.from_numpy(
        rng.uniform(10, 60, c).astype(np.float32))
    mult = torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32))
    return values, budgets, mult


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
@pytest.mark.parametrize("case", sorted(VI_CASES))
def test_vi_kernel_is_the_cpu_loop(dev, case, kind):
    """estimate_pi on the card, one vi launch, is the CPU loop bit for
    bit: pi and the tracked history."""
    b, coupling, k, iters, c, p0, track = VI_CASES[case]
    values, budgets, mult = _vi_env(c)
    kw = dict(sample_size=k, num_iters=iters, batch_size=b,
              coupling=coupling, eta_decay=0.05, track_every=track)
    pi0 = None if p0 is None else torch.full((c,), p0)
    out = {}
    for where in ("cpu", dev):
        rule = AuctionRule(multipliers=mult.to(where),
                           reserve=torch.tensor(0.02, device=where),
                           kind=kind)
        cuda_vi.reset_launches()
        out[str(where)] = vi.estimate_pi(
            values.to(where), budgets.to(where), rule,
            prng.PRNGKey(3).to(where),
            pi0=None if pi0 is None else pi0.to(where), **kw)
    assert cuda_vi.LAUNCHES == {"vi": 1, "vi_device_state": 0}
    assert torch.equal(out[str(dev)].pi.cpu(), out["cpu"].pi)
    if track:
        assert torch.equal(out[str(dev)].history.cpu(), out["cpu"].history)
    assert not torch.equal(out["cpu"].pi, torch.ones(c))


@pytest.mark.parametrize("coupling", ["shared", "independent"])
def test_vi_kernel_state_in_device_memory(dev, coupling):
    """The first C whose staged state does not fit in shared memory (64-row
    batches): the state lives in device memory, one launch, the CPU's
    bits."""
    w = 1 if coupling == "shared" else None
    c = 16
    while cuda_vi.staged(64, c + 1, w or c + 1):
        c += 1
    c += 1
    values, budgets, mult = _vi_env(c, seed=6)
    out = {}
    for where in ("cpu", dev):
        rule = AuctionRule(multipliers=mult.to(where),
                           reserve=torch.tensor(0.02, device=where),
                           kind="second_price")
        cuda_vi.reset_launches()
        out[str(where)] = vi.estimate_pi(
            values.to(where), budgets.to(where) * c / 16, rule,
            prng.PRNGKey(4).to(where), sample_size=300, num_iters=3,
            batch_size=64, coupling=coupling)
    assert cuda_vi.LAUNCHES == {"vi": 1, "vi_device_state": 1}
    assert torch.equal(out[str(dev)].pi.cpu(), out["cpu"].pi)


@pytest.mark.parametrize("coupling", ["shared", "independent"])
def test_vi_kernel_at_the_staged_gate(dev, coupling):
    """The last C whose staged state (a ring of at least two batches) fits
    in shared memory (64-row batches): one staged launch, the CPU's
    bits."""
    w = 1 if coupling == "shared" else None
    c = 16
    while cuda_vi.staged(64, c + 1, w or c + 1):
        c += 1
    values, budgets, mult = _vi_env(c, seed=8)
    out = {}
    for where in ("cpu", dev):
        rule = AuctionRule(multipliers=mult.to(where),
                           reserve=torch.tensor(0.02, device=where),
                           kind="first_price")
        cuda_vi.reset_launches()
        out[str(where)] = vi.estimate_pi(
            values.to(where), budgets.to(where) * c / 16, rule,
            prng.PRNGKey(4).to(where), sample_size=300, num_iters=3,
            batch_size=64, coupling=coupling)
    assert cuda_vi.LAUNCHES == {"vi": 1, "vi_device_state": 0}
    assert torch.equal(out[str(dev)].pi.cpu(), out["cpu"].pi)


@pytest.mark.parametrize("coupling", ["shared", "independent"])
def test_vi_sweep_second_price_ties_at_a_zero_reserve(dev, coupling):
    """Valuations in eighths, unit multipliers on most lanes and a zero
    reserve: ties for the top bid (the second price is the best) and
    zero bids at the reserve; 33 lanes in one launch, the CPU's lanes bit
    for bit."""
    rng = np.random.default_rng(12)
    c = 24
    values = torch.from_numpy((rng.integers(0, 8, (4096, c)) / 8).astype(
        np.float32))
    budgets = torch.from_numpy(rng.uniform(10, 60, c).astype(np.float32))
    mult = torch.ones((33, c))
    mult[::3] = 1.5
    out = {}
    for where in ("cpu", dev):
        rules = AuctionRule(multipliers=mult.to(where),
                            reserve=torch.zeros(33, device=where),
                            kind="second_price")
        cuda_vi.reset_launches()
        out[str(where)] = vi.estimate_pi_sweep(
            values.to(where), (budgets[None] * torch.linspace(
                0.5, 1.5, 33)[:, None]).to(where), rules,
            prng.PRNGKey(6).to(where), sample_size=400, num_iters=4,
            batch_size=64, coupling=coupling)
    assert cuda_vi.LAUNCHES["vi"] == 1
    assert torch.equal(out[str(dev)].pi.cpu(), out["cpu"].pi)


def test_vi_sweep_kernel_is_the_cpu_lanes(dev):
    """estimate_pi_sweep: five lanes in one vi launch, with a pi0, bitwise
    the CPU's lane loop."""
    values, budgets, mult = _vi_env(24, seed=7)
    scales = torch.tensor([1.0, 0.5, 2.0, 1.0, 0.8])
    out = {}
    for where in ("cpu", dev):
        rules = AuctionRule(
            multipliers=(mult[None] * torch.tensor(
                [1.0, 1.0, 1.0, 1.3, 0.9])[:, None]).to(where),
            reserve=torch.tensor([0.0, 0.02, 0.0, 0.05, 0.0], device=where),
            kind="first_price")
        cuda_vi.reset_launches()
        out[str(where)] = vi.estimate_pi_sweep(
            values.to(where), (budgets[None] * scales[:, None]).to(where),
            rules, prng.PRNGKey(5).to(where), sample_size=333,
            num_iters=5, batch_size=64, eta_decay=0.05,
            pi0=torch.full((5, 24), 0.95, device=where))
    assert cuda_vi.LAUNCHES["vi"] == 1
    assert torch.equal(out[str(dev)].pi.cpu(), out["cpu"].pi)
    assert torch.equal(out[str(dev)].num_updates, out["cpu"].num_updates)


def _segment_table(case, s, n, c, rng):
    """(boundaries (S, K+2), masks (S, K+1, C)) of one edge case."""
    tile = cuda_sg.ROWS_PER_CTA
    if case == "hand_built":                # not monotone, 0 and N inner
        k = 9
        inner = np.sort(np.concatenate(
            [rng.integers(0, n + 1, (s, k - 3)),
             np.tile([0, min(tile, n), n], (s, 1))], axis=1), axis=1)
        bounds = np.concatenate([np.zeros((s, 1)), inner,
                                 np.full((s, 1), n)], axis=1)
        masks = rng.uniform(size=(s, k + 1, c)) < 0.6
        return (torch.from_numpy(bounds.astype(np.int32)),
                torch.from_numpy(masks))
    caps = rng.integers(1, n + 1, (s, c))
    if case == "tile_edges":
        edges = np.array([tile, 2 * tile, 3 * tile + 1, 4 * tile - 1, n - 1])
        caps = edges[rng.integers(0, len(edges), (s, c))]
    elif case == "every_tile":          # on tile starts, runs' starts too
        caps = tile * rng.integers(1, n // tile, (s, c)) \
            + rng.integers(0, 2, (s, c))
    elif case == "duplicates":
        caps = rng.choice([n // 5, n // 2, n // 2, n // 2, n - 3], (s, c))
    elif case == "cap_at_1_and_n":
        caps[:, 0], caps[:, 1], caps[:, 2], caps[:, 3] = 1, n, n + 1, 10 * n
        caps[::2, 4:7] = 1
    segs = Segments.from_cap_times(torch.from_numpy(caps.astype(np.int32)),
                                   n)
    return segs.boundaries, segs.masks


def _segment_inputs(case, s, n, c, seed):
    rng = np.random.default_rng(seed)
    values, mult, _, _ = _coarse(s, n, c, seed)
    res = torch.from_numpy(rng.choice([0.0, 0.125, 0.3], s).astype(
        np.float32))
    return (values, mult, res) + _segment_table(case, s, n, c, rng)


# (case, S, N, C): the CPU tests' edges, N below one tile and one past it,
# C no multiple of 4 (4-byte copies), S past the 32 lanes staged together
SEGMENT_EDGES = {
    "tile_edges_s1": ("tile_edges", 1, 1000, 12),
    "tile_edges_s33": ("tile_edges", 33, 1000, 12),
    "duplicates_s33": ("duplicates", 33, 3000, 100),
    "cap_at_1_and_n_s5": ("cap_at_1_and_n", 5, 1000, 37),
    "hand_built_s33": ("hand_built", 33, 1000, 12),
    "hand_built_n1": ("hand_built", 2, 1, 12),
    "hand_built_n129": ("hand_built", 3, 129, 7),
    "duplicates_n127": ("duplicates", 4, 127, 100),
    # the persistent grid: runs of several tiles a CTA, boundaries on tile
    # and run starts; one bulk copy a tile (C=100), a bulk copy a row into
    # padded rows (C=40, ten quads), 4-byte copies (C=37)
    "runs_every_tile_s32": ("every_tile", 32, 50_765, 100),
    "runs_c40_padded": ("duplicates", 8, 40_000, 40),
    "runs_c37_hand_built_s33": ("hand_built", 33, 30_000, 37),
}


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("case", sorted(SEGMENT_EDGES))
def test_segment_resolve_kernel_edges_give_the_cpu_bits(dev, case, sp):
    kind, s, n, c = SEGMENT_EDGES[case]
    values, mult, res, bounds, masks = _segment_inputs(kind, s, n, c,
                                                       seed=len(case) + s)
    want = ref.segment_resolve_plain(values, mult, res, bounds, masks, sp)
    cuda_sg.reset_launches()
    got = ops.segment_resolve(values.to(dev), mult.to(dev), res.to(dev),
                              bounds.to(dev), masks.to(dev),
                              second_price=sp)
    torch.cuda.synchronize()
    assert cuda_sg.LAUNCHES["segment_resolve"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("sp", [False, True])
def test_segment_resolve_ties_at_a_zero_reserve(dev, sp):
    """Valuations in eighths, unit multipliers and a zero reserve: ties for
    the top bid (the first column wins, the second price is the best) and
    zero bids that never beat the reserve; S=33, the CPU's bits."""
    rng = np.random.default_rng(13)
    n, c, s = 3000, 100, 33
    values = torch.from_numpy((rng.integers(0, 8, (n, c)) / 8).astype(
        np.float32))
    mult = torch.ones((s, c))
    res = torch.zeros(s)
    bounds, masks = _segment_table("duplicates", s, n, c, rng)
    want = ref.segment_resolve_plain(values, mult, res, bounds, masks, sp)
    got = ops.segment_resolve(values.to(dev), mult.to(dev), res.to(dev),
                              bounds.to(dev), masks.to(dev),
                              second_price=sp)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert bool((want[0] >= 0).any())


@pytest.mark.parametrize("above", [False, True])
def test_segment_resolve_at_and_above_its_shared_memory(dev, above):
    """C at the kernel's limit runs the kernel; one more takes the
    per-lane MatrixTile route, counted. Both are the CPU's bits."""
    c = cuda_sg.max_campaigns() + int(above)
    values, mult, res, bounds, masks = _segment_inputs("duplicates", 3, 600,
                                                       c, seed=9)
    want = ref.segment_resolve_plain(values, mult, res, bounds, masks, True)
    cuda_sg.reset_launches()
    cuda_ar.reset_launches()
    ops.reset_paths()
    got = ops.segment_resolve(values.to(dev), mult.to(dev), res.to(dev),
                              bounds.to(dev), masks.to(dev),
                              second_price=True)
    torch.cuda.synchronize()
    assert cuda_sg.LAUNCHES["segment_resolve"] == int(not above)
    assert ops.PATHS["segment_resolve_per_lane"] == int(above)
    assert cuda_ar.LAUNCHES["auction_resolve"] == 3 * int(above)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("emb", [False, True])
def test_sums_of_long_resolves_are_the_flat_sums(dev, emb):
    """A resolve of 8,193 rows: the sums are first_crossing's flat sums
    (counted), the event-ordered sums of the kernel's sales on the CPU;
    winners and prices are the plain version's on the card."""
    n, c = 8193, 37
    rng = np.random.default_rng(12)
    mult = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    act = torch.from_numpy(rng.uniform(size=c) < 0.8).to(dev)
    res = torch.tensor(0.05, device=dev)
    if emb:
        e, r, _, _ = _emb(n, c, 6, False, 13)
        args = (e.to(dev), r.to(dev))
        fn, plain = ops.auction_resolve, ref.auction_resolve_ref
    else:
        args = (torch.from_numpy(rng.uniform(0, 1, (n, c)).astype(
            np.float32)).to(dev),)
        fn, plain = ops.resolve_masked, ref.resolve_masked_ref
    ops.reset_paths()
    got = fn(*args, mult.to(dev), act, res, second_price=True)
    want = plain(*args, mult.to(dev), act, res, second_price=True)
    torch.cuda.synchronize()
    assert ops.PATHS["auction_resolve_flat_sums"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2].cpu(), auction.spend_sums(
        got[0].cpu(), got[1].cpu(), c))


FLASH_SHAPES = [   # b, s, h, kv, dh, causal, window, dtype
    (8, 2048, 32, 32, 64, True, None, torch.bfloat16),    # stablelm prefill
    (8, 2048, 32, 32, 64, True, None, torch.float32),
    (1, 4096, 8, 4, 256, True, 1024, torch.bfloat16),     # gemma3-4b local
    (2, 1000, 4, 2, 128, True, None, torch.float32),      # ragged S
    (1, 333, 6, 3, 32, False, 50, torch.float32),         # window, not causal
    (2, 130, 4, 1, 16, False, None, torch.bfloat16),
    # the bf16 tensor-core kernel: every head dim, S against its 128-row
    # query tiles (64 at dh=256), a window cutting a 64-row kv tile, GQA 8:1
    (2, 40, 4, 2, 16, True, None, torch.bfloat16),        # below one tile
    (2, 127, 4, 4, 32, True, None, torch.bfloat16),
    (2, 129, 4, 2, 64, True, None, torch.bfloat16),
    (2, 1000, 4, 2, 128, True, None, torch.bfloat16),
    (1, 300, 4, 2, 256, True, 77, torch.bfloat16),
    (1, 500, 16, 2, 64, True, 77, torch.bfloat16),        # GQA 8:1
    (2, 333, 8, 1, 32, False, 77, torch.bfloat16),        # GQA 8:1
    (1, 257, 2, 2, 128, False, None, torch.bfloat16),
    # the float32 split-TF32 kernel: every head dim, S against its query
    # tiles, a window cutting a kv tile (64 keys; 32 at dh=256), GQA 8:1,
    # B*H past the old 65,535 limit of its grid
    (2, 40, 4, 2, 16, True, None, torch.float32),
    (2, 129, 4, 4, 32, True, None, torch.float32),
    (1, 500, 16, 2, 64, True, 77, torch.float32),         # GQA 8:1
    (1, 257, 2, 2, 128, False, None, torch.float32),
    (1, 300, 4, 2, 256, True, 77, torch.float32),
    (2, 100, 4, 1, 256, False, 40, torch.float32),
    (16385, 8, 4, 1, 64, True, None, torch.float32),      # B*H = 65,540
]


@pytest.mark.parametrize("b,s,h,kv,dh,causal,window,dtype", FLASH_SHAPES)
def test_flash_attention_matches_plain(dev, b, s, h, kv, dh, causal, window,
                                       dtype):
    """The kernel against its plain version on the card, at
    tests/test_kernels.py's tolerances (2e-5 float32, 2e-2 bfloat16), and
    two launches bitwise equal. In bfloat16 the kernel's tensor cores take
    the probabilities as two bfloat16 terms (16 significant bits, not
    rounded to bfloat16 as ``repro``'s model attention rounds them), so
    both sides are float32-accurate up to 2^-16 in P and round the output
    once: they agree within two output ulps at each row's scale (2^-6 of
    the row's largest value)."""
    _check_flash(dev, b, s, h, kv, dh, causal, window, dtype)


# whisper-small's encoder: bidirectional attention over 1,500 frames
# (11 x 128 + 92 query rows, 23 x 64 + 28 keys), and ragged S around one
# query tile and one kv tile, at both kernels' dh of 64 and 128
NON_CAUSAL_SHAPES = [(b, s, h, kv, dh, dtype)
                     for dh, (b, h, kv) in ((64, (2, 12, 12)), (128, (1, 8, 2)))
                     for s in (1, 63, 65, 129, 1500)
                     for dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("b,s,h,kv,dh,dtype", NON_CAUSAL_SHAPES)
def test_flash_attention_non_causal_matches_plain(dev, b, s, h, kv, dh,
                                                  dtype):
    """``causal=False``, the encoder's mode: every key tile of every query
    tile, the ragged tails masked, against the plain version as above."""
    _check_flash(dev, b, s, h, kv, dh, False, None, dtype)


def _check_flash(dev, b, s, h, kv, dh, causal, window, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(s + h)
    q = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
    before = cuda_fa.LAUNCHES["flash_attention"]
    before_nc = cuda_fa.NON_CAUSAL_LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    again = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa_ref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert cuda_fa.LAUNCHES["flash_attention"] == before + 2
    assert cuda_fa.NON_CAUSAL_LAUNCHES["flash_attention"] == \
        before_nc + (0 if causal else 2)
    assert got.dtype == dtype and torch.equal(got, again)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        scale = want.float().abs().amax(dim=-1, keepdim=True)
        assert ((got.float() - want.float()).abs() <= 2.0 ** -6 * scale).all()


# the backward kernels' edges: every head dim, S below one 64-row tile and
# ragged past one, windows cutting a tile (64 keys; 32 at dh=256), GQA 8:1
# and 3:1, not causal with and without a window
FLASH_BWD_SHAPES = [
    (2, 40, 4, 2, 16, True, None),
    (2, 129, 4, 4, 32, False, None),
    (1, 500, 16, 2, 64, True, 77),        # GQA 8:1
    (2, 1000, 6, 2, 64, True, None),      # GQA 3:1, ragged
    (2, 333, 8, 4, 32, False, 50),
    (1, 257, 2, 2, 128, False, None),
    (1, 300, 8, 1, 128, True, None),
    (1, 300, 4, 2, 256, True, 77),
    (2, 100, 4, 1, 256, False, 40),
    # the bf16 tensor-core kernels' tiles, S at and one past their edges:
    # 64 keys a dK/dV CTA and 64 rows a dQ CTA at every dh; query tiles of
    # the dK/dV ring and kv tiles of the dQ ring of 64 rows at dh <= 64 and
    # of 32 above
    (1, 64, 2, 1, 16, True, None),
    (2, 65, 4, 2, 16, False, None),
    (1, 64, 4, 4, 32, False, None),
    (1, 65, 4, 2, 32, True, 20),
    (2, 64, 4, 2, 64, True, None),
    (1, 65, 6, 3, 64, False, 9),
    (1, 32, 2, 2, 128, True, None),
    (1, 33, 4, 2, 128, False, None),
    (1, 64, 4, 1, 128, True, 40),
    (1, 65, 2, 2, 128, True, None),
    (1, 32, 2, 1, 256, False, None),
    (1, 33, 4, 2, 256, True, None),
    (1, 64, 2, 2, 256, True, 17),
    (1, 65, 4, 4, 256, False, None),
]
# the bf16 kernels against ref.attention_bwd_bf16_ref, the CPU mirror of
# their roundings of P and dS: two output ulps at each tensor's largest
# values (max |diff| / max |mirror|; read <= 4.5e-3 at phase 18 (a)'s
# shapes, tools/flash_bwd_designs.py on an NVIDIA H100 80GB HBM3 at 700 W)
FLASH_BWD_MIRROR_TOL = 2.0 ** -6


def _bwd_inputs(dev, b, s, h, kv, dh, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, s, h, dh), generator=gen, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kv,dh,causal,window", FLASH_BWD_SHAPES)
def test_flash_attention_bwd_matches_plain(dev, b, s, h, kv, dh, causal,
                                           window, dtype):
    """The backward kernel against its plain version on the same q, k, v,
    output, output gradient and logsumexp (the forward kernel's), max
    |diff| over max |plain| within 2e-2 in bfloat16 (one rounding of each
    gradient) and 1e-4 in float32, and in bfloat16 also against the CPU
    mirror of its roundings within ``FLASH_BWD_MIRROR_TOL``; the forward's
    logsumexp within 1e-5 of the plain one; two launches give the same
    bits."""
    q, k, v, do = _bwd_inputs(dev, b, s, h, kv, dh, dtype, s + dh)
    o, lse = cuda_fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window, with_lse=True)
    _, want_lse = fa_ref.attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    before = cuda_fab.LAUNCHES["flash_attention_bwd"]
    got = cuda_fab.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                            causal=causal, window=window)
    again = cuda_fab.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                              causal=causal, window=window)
    want = fa_ref.attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    assert cuda_fab.LAUNCHES["flash_attention_bwd"] == before + 2
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (name, err)
    if dtype == torch.bfloat16:
        mirror = fa_ref.attention_bwd_bf16_ref(q, k, v, o, do, lse,
                                               causal=causal, window=window)
        for name, g, w in zip(("dq", "dk", "dv"), got, mirror):
            err = float((g.float() - w.float()).abs().max())
            assert err <= FLASH_BWD_MIRROR_TOL * float(w.float().abs().max()),\
                (name, err)


@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_flash_attention_bwd_routes(dev, dh):
    """bfloat16 takes the tensor-core kernels (``TENSOR_CORE_LAUNCHES``
    counts it) at every head dim, float32 the CUDA-core ones (counted in
    ``LAUNCHES`` alone), each giving the same bits twice."""
    for dtype, tensor_cores in ((torch.bfloat16, 1), (torch.float32, 0)):
        q, k, v, do = _bwd_inputs(dev, 1, 130, 4, 2, dh, dtype, dh)
        o, lse = cuda_fa.flash_attention_cuda(q, k, v, with_lse=True)
        calls = cuda_fab.LAUNCHES["flash_attention_bwd"]
        tc = cuda_fab.TENSOR_CORE_LAUNCHES["flash_attention_bwd"]
        got = cuda_fab.flash_attention_bwd_cuda(q, k, v, o, do, lse)
        again = cuda_fab.flash_attention_bwd_cuda(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        assert cuda_fab.LAUNCHES["flash_attention_bwd"] == calls + 2
        assert cuda_fab.TENSOR_CORE_LAUNCHES["flash_attention_bwd"] == \
            tc + 2 * tensor_cores
        assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_flash_attention_lse_leaves_the_output_bits(dev):
    """Asking the forward for its logsumexp changes none of its output's
    bits, in either kernel."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _ = _bwd_inputs(dev, 2, 300, 4, 2, 64, dtype, 3)
        plain = cuda_fa.flash_attention_cuda(q, k, v, window=77)
        out, _ = cuda_fa.flash_attention_cuda(q, k, v, window=77,
                                              with_lse=True)
        assert torch.equal(out, plain)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_autograd_on_the_card(dev, dtype):
    """Where autograd records, ``ops.flash_attention`` runs the forward
    kernel with its logsumexp and then the backward kernel, one launch
    each, and its gradients are the CPU's plain ones within the kernel
    tolerances; with grad off it launches the forward alone."""
    q, k, v, do = _bwd_inputs(dev, 2, 200, 6, 2, 64, dtype, 5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd = cuda_fa.LAUNCHES["flash_attention"]
    bwd = cuda_fab.LAUNCHES["flash_attention_bwd"]
    out = fa_ops.flash_attention(*leaves, window=50)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert cuda_fa.LAUNCHES["flash_attention"] == fwd + 1
    assert cuda_fab.LAUNCHES["flash_attention_bwd"] == bwd + 1
    cpu = [t.cpu().requires_grad_() for t in (q, k, v)]
    want_out = fa_ops.flash_attention(*cpu, window=50)
    want = torch.autograd.grad(want_out, cpu, do.cpu())
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(grads, want):
        err = float((g.cpu().float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max())
    with torch.no_grad():
        fa_ops.flash_attention(*leaves, window=50)
    assert cuda_fab.LAUNCHES["flash_attention_bwd"] == bwd + 1


def test_flash_attention_bwd_refuses_an_unaligned_gradient(dev):
    """The backward kernel loads 16 bytes at a time: an output gradient
    that starts off a 16-byte boundary is refused, nothing launched."""
    q, k, v, _ = _bwd_inputs(dev, 1, 64, 2, 2, 64, torch.float32, 0)
    o, lse = cuda_fa.flash_attention_cuda(q, k, v, with_lse=True)
    do = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    before = cuda_fab.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        cuda_fab.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    assert cuda_fab.LAUNCHES["flash_attention_bwd"] == before


def test_flash_attention_folded_heads(dev):
    """The Pallas kernel's (BH, S, dh) layout is the case H = KV = 1."""
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((6, 300, 64), generator=gen, device=dev)
               for _ in range(3))
    got = cuda_fa.flash_attention_cuda(q[:, :, None], k[:, :, None],
                                       v[:, :, None], window=77)[:, :, 0]
    want = fa_ref.flash_attention_ref(q, k, v, window=77)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_f32_refuses_an_unaligned_tensor(dev):
    """The float32 kernel copies 16 bytes at a time too."""
    q = torch.zeros(2 * 64 * 2 * 64 + 2, device=dev)[2:].view(2, 64, 2, 64)
    k = torch.zeros((2, 64, 2, 64), device=dev)
    before = cuda_fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa_ops.flash_attention(q, k, k)
    assert cuda_fa.LAUNCHES["flash_attention"] == before


def test_flash_attention_bf16_refuses_an_unaligned_tensor(dev):
    """The bf16 kernel copies 16 bytes at a time: a contiguous view that
    starts off a 16-byte boundary is refused, and nothing is launched."""
    q = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.bfloat16,
                    device=dev)[1:].view(2, 64, 2, 64)
    k = torch.zeros((2, 64, 2, 64), dtype=torch.bfloat16, device=dev)
    before = cuda_fa.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa_ops.flash_attention(q, k, k)
    assert cuda_fa.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma3-4b"])
def test_reduced_prefill_on_the_card_is_the_plain_path(dev, arch,
                                                       monkeypatch):
    """A reduced model's prefill through the kernel (one launch per layer)
    against the same model with the plain attention, both on the card:
    logits within 1e-2 of their scale (float32 scores and softmax either
    way, the kernel's probabilities split into two bfloat16 terms; a
    bfloat16 context may round the other way)."""
    cfg = reduced_config(arch)
    model = build_model(cfg, device=dev, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (3, 40),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    cuda_fa.reset_launches()
    got, caches = model.prefill(tokens, 48)
    torch.cuda.synchronize()
    assert cuda_fa.LAUNCHES["flash_attention"] == cfg.n_layers
    monkeypatch.setattr(t_attention, "flash_attention", fa_ref.attention_ref)
    want, plain_caches = model.prefill(tokens, 48)
    assert cuda_fa.LAUNCHES["flash_attention"] == cfg.n_layers
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())
    assert torch.equal(caches[0].k, plain_caches[0].k)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b",
                                  "jamba-v0.1-52b", "xlstm-125m"])
def test_reduced_moe_and_recurrent_models_on_the_card_are_the_cpus(dev,
                                                                  arch):
    """A reduced model of each new layer kind (MoE MLP, mamba, mLSTM,
    sLSTM) on the card against the same weights on the CPU: prefill and 4
    teacher-forced decode steps, one ``flash_attention`` launch an
    attention layer, twice, as ``chip_smoke.py`` phase 16 holds them: as
    served, bfloat16 logits within 2e-2 of the CPU's scale
    (``LM_TOL``), then both models cast to float32, logits within 2^-10
    (``F32_TOL``). xlstm-125m's bfloat16 logits are not held: its sLSTM
    recurrence, at the reference's initialisation, amplifies rounding past
    2e-2 (3.4e-2 here with bfloat16 tensor-core products on an NVIDIA H100
    80GB HBM3), so its float32 twin alone tells a wrong layer from
    rounding. Where the CPU's MoE routing differs from the card's at a
    near tie (probabilities within 2^-7), the CPU follows the card
    (``moe.follow_routing``; it raises past that)."""
    from repro_torch.models import Model
    from repro_torch.models import moe as t_moe
    cfg = reduced_config(arch)
    card = build_model(cfg, device=dev, seed=0)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    seq = torch.randint(0, cfg.vocab_size, (2, 44),
                        generator=torch.Generator().manual_seed(2))
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2.0 ** -10)):
        if dtype == torch.float32:
            card.float()
            cpu.float()
        routes, runs = [], {}
        for name, m in (("card", card), ("cpu", cpu)):
            with (t_moe.record_routing(routes) if name == "card"
                  else t_moe.follow_routing(routes, 2.0 ** -7)):
                cuda_fa.reset_launches()
                logits, caches = m.prefill(seq[:, :40].to(m.device), 48)
                out = [logits.float().cpu()]
                if name == "card":
                    torch.cuda.synchronize()
                    assert cuda_fa.LAUNCHES["flash_attention"] == sum(
                        ls.kind == "attn" for ls in cfg.layers)
                for pos in range(40, 44):
                    logits, caches = m.decode_step(
                        caches, seq[:, pos:pos + 1].to(m.device), pos)
                    out.append(logits.float().cpu())
            runs[name] = out
        assert bool(routes) == bool(cfg.n_experts)
        if dtype == torch.bfloat16 and arch == "xlstm-125m":
            continue
        for a, b in zip(runs["card"], runs["cpu"]):
            assert float((a - b).abs().max()) < tol * float(b.abs().max())


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-76b"])
def test_reduced_encdec_and_vlm_on_the_card_are_the_cpus(dev, arch):
    """Reduced whisper-small (the encoder's flash launches with
    ``causal=False``) and internvl2-76b (the patch prefix) on the card
    against the same weights on the CPU: prefill and 4 teacher-forced
    decode steps, one ``flash_attention`` launch an encoder and a decoder
    layer, bfloat16 logits within 2e-2 of the CPU's scale (``LM_TOL``),
    then both models cast to float32 (the frames or patches float32 as
    given), within 2^-10 (``F32_TOL``), as ``chip_smoke.py`` phase 17
    holds them."""
    from repro_torch.models import new_model
    cfg = reduced_config(arch)
    card = build_model(cfg, device=dev, seed=0)
    cpu = new_model(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    gen = torch.Generator().manual_seed(2)
    seq = torch.randint(0, cfg.vocab_size, (2, 44), generator=gen)
    stub = torch.randn((2, cfg.encoder_frames or cfg.num_patches,
                        cfg.d_model), generator=gen)
    what = "frames" if cfg.is_encdec else "patch_embeds"
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2.0 ** -10)):
        if dtype == torch.float32:
            card.float()
            cpu.float()
        runs = {}
        for name, m in (("card", card), ("cpu", cpu)):
            cuda_fa.reset_launches()
            logits, caches = m.prefill(seq[:, :40].to(m.device), 48,
                                       **{what: stub.to(m.device)})
            out = [logits.float().cpu()]
            if name == "card":
                torch.cuda.synchronize()
                assert cuda_fa.LAUNCHES["flash_attention"] == \
                    cfg.n_layers + cfg.encoder_layers
                assert cuda_fa.NON_CAUSAL_LAUNCHES["flash_attention"] == \
                    cfg.encoder_layers
            for pos in range(40, 44):
                logits, caches = m.decode_step(
                    caches, seq[:, pos:pos + 1].to(m.device),
                    pos + cfg.num_patches)
                out.append(logits.float().cpu())
            runs[name] = out
        for a, b in zip(runs["card"], runs["cpu"]):
            assert float((a - b).abs().max()) < tol * float(b.abs().max())


@pytest.mark.parametrize("temperature", [0.5, 0.7, 1.3])
def test_sampler_on_the_card_is_the_cpus(dev, temperature):
    """``ServeEngine._sample`` on bfloat16 logits on the card (drawing on
    the card) against the same logits copied to the host and the same
    keys: bit for bit, over 1,000 keys at once and one key at a time, on
    logits with frequent ties of ``gumbel + logits`` and on spread ones;
    the bfloat16 uniforms and Gumbel noise too."""
    import types
    from repro_torch.serve import ServeEngine
    cfg = types.SimpleNamespace(vocab_size=5_000, num_patches=0)
    eng = ServeEngine(types.SimpleNamespace(cfg=cfg), max_len=0,
                      temperature=temperature)
    keys = prng.split(prng.PRNGKey(7), 1000)
    gen = torch.Generator().manual_seed(3)
    for logits in ((torch.randint(0, 6, (8, 1, 5_120), generator=gen) / 4),
                   torch.randn((8, 1, 5_120), generator=gen) * 3):
        logits = logits.bfloat16()
        got = eng._sample(logits.to(dev), keys.to(dev))
        assert got.device == logits.to(dev).device
        assert torch.equal(got.cpu(), eng._sample(logits, keys))
        for i in (0, 1, 999):
            assert torch.equal(eng._sample(logits.to(dev), keys[i]).cpu(),
                               eng._sample(logits, keys[i]))
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(prng.gumbel(keys.to(dev), (4, 33), dtype).cpu(),
                           prng.gumbel(keys, (4, 33), dtype))
    assert torch.equal(
        prng.uniform(keys.to(dev), (4, 33), dtype=torch.bfloat16).cpu(),
        prng.uniform(keys, (4, 33), dtype=torch.bfloat16))


def test_lm_entry_points_default_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = build_model(reduced_config("stablelm-1.6b"))
    assert model.device.type == "cuda"
    assert get_config("stablelm-1.6b").d_model == 2048


# ---------------------------------------------------------------------------
# The chunked replays' kernel modes: first_crossing with a carry,
# segment_resolve at a row offset, capped_scan with a scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,epc", [(16, 16), (1, 7), (4096, 8192),
                                       (17, 1020), (1000, 3000),
                                       (4097, 4097), (6000, 6000)])
@pytest.mark.parametrize("c", [12, 150])
def test_first_crossing_carry_is_one_call_and_the_cpu(dev, block, epc, c):
    """Chunk by chunk with a carry (chunks of one block, a chunk of one
    event, blocks of <= 16 rows, blocks past the kernel's 4,096-row tile,
    C past one CTA's 256 campaigns), the card's cap times and running
    spend are one whole-log call's and the CPU's chunk by chunk; a chunk
    boundary falls on a crossing (lane 0, campaign 0 reaches its budget on
    the first chunk's last row) and campaigns capped in an earlier chunk
    keep their time. A carried call asks for the cap times only: three
    device kernels."""
    s, n = 3, 12_000 - 12_000 % epc
    winners, prices, budgets = _crossing_log(s, n, c, block, seed=epc + c)
    winners[0, epc - 1], prices[0, epc - 1] = 0, 0.75
    s0, _ = segments.crossing_carry(
        winners[:, :epc], prices[:, :epc], budgets, c, block,
        s0=torch.zeros((s, c)), cap=torch.full((s, c), n + 1,
                                               dtype=torch.int32),
        offset=0, n_global=n)
    budgets[0, 0] = s0[0, 0]
    _, whole = segments.crossing_and_spend(winners.to(dev), prices.to(dev),
                                           budgets.to(dev), c, block)
    assert int(whole[0, 0]) == epc
    card = (torch.zeros((s, c), device=dev),
            torch.full((s, c), n + 1, dtype=torch.int32, device=dev))
    cpu = (torch.zeros((s, c)), torch.full((s, c), n + 1, dtype=torch.int32))
    cuda_fc.reset_launches()
    for off in range(0, n, epc):
        sl = slice(off, off + epc)
        card = segments.crossing_carry(
            winners[:, sl].to(dev), prices[:, sl].to(dev), budgets.to(dev),
            c, block, s0=card[0], cap=card[1], offset=off, n_global=n)
        cpu = segments.crossing_carry(
            winners[:, sl], prices[:, sl], budgets, c, block, s0=cpu[0],
            cap=cpu[1], offset=off, n_global=n)
        assert torch.equal(card[0].cpu(), cpu[0])
        assert torch.equal(card[1].cpu(), cpu[1])
    torch.cuda.synchronize()
    assert cuda_fc.LAUNCHES["first_crossing"] == n // epc
    assert cuda_fc.LAUNCHES["first_crossing_device_kernels"] == 3 * (n // epc)
    assert torch.equal(card[1], whole)
    assert bool((whole < n).sum() > 2)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("offset,rows", [(0, 1000), (128, 256), (1, 129),
                                         (2871, 129), (1000, 2000)])
def test_segment_resolve_at_an_offset_is_the_whole_calls_rows(dev, sp,
                                                              offset, rows):
    """A chunk of rows at a global offset (on and off the 128-row tile,
    boundaries at the chunk's first row, duplicates, S=33 past the 32
    lanes staged together): the same rows of a whole-log call on the card,
    and the CPU's plain version at the offset."""
    values, mult, res, bounds, masks = _segment_inputs("duplicates", 33,
                                                       3000, 100, seed=rows)
    bounds = bounds.clone()
    bounds[0, 3] = offset
    bounds[1, 1:4] = offset + 1
    bounds = torch.sort(bounds, dim=1).values
    whole = ops.segment_resolve(values.to(dev), mult.to(dev), res.to(dev),
                                bounds.to(dev), masks.to(dev),
                                second_price=sp)
    sl = slice(offset, offset + rows)
    cuda_sg.reset_launches()
    got = ops.segment_resolve(values[sl].to(dev), mult.to(dev), res.to(dev),
                              bounds.to(dev), masks.to(dev),
                              second_price=sp, offset=offset)
    want = ref.segment_resolve_plain(values[sl], mult, res, bounds, masks,
                                     sp, offset=offset)
    torch.cuda.synchronize()
    assert cuda_sg.LAUNCHES["segment_resolve"] == 1
    for a, w, b in zip(got, whole, want):
        assert torch.equal(a, w[:, sl])
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("c", [64, "past_shared"])
@pytest.mark.parametrize("sp", [False, True])
def test_capped_scan_with_a_scale_is_the_cpu(dev, c, sp):
    """The sampled replay's capped scan, each sale's increment times 1/rho
    (rho = 1% and 3/7), bitwise the plain version on the CPU; with the
    lane state in shared memory and, past its limit, in device memory. A
    scale of 1 is the exact replay's launch, bit for bit."""
    if c == "past_shared":
        c = cuda_cs._lib().cs_max_shared_campaigns() + 1
    n, s = 2000, 3
    rng = np.random.default_rng(c)
    values = torch.from_numpy(rng.random((n, c), dtype=np.float32))
    mult = torch.from_numpy(rng.uniform(0.5, 1.5, (s, c)).astype(np.float32))
    res = torch.tensor([0.0, 0.05, 0.1])
    for scale in (100.0, 7 / 3, 1.0):
        b = torch.from_numpy(rng.uniform(1.0, 6.0, (s, c)).astype(
            np.float32)) * scale * 400 / c
        b[0, 0] = 0.0
        want = scan_ops.capped_scan(values, b, mult, res, second_price=sp,
                                    scale=scale)
        got = scan_ops.capped_scan(values.to(dev), b.to(dev), mult.to(dev),
                                   res.to(dev), second_price=sp, scale=scale)
        for a, w in zip(got, want):
            assert torch.equal(a.cpu(), w)
        assert int((want[3] <= n).sum()) > s
    exact = scan_ops.capped_scan(values.to(dev), b.to(dev), mult.to(dev),
                                 res.to(dev), second_price=sp)
    for a, w in zip(exact, got):
        assert torch.equal(a, w)


def test_naive_sampling_on_the_card_is_the_cpu(dev):
    env = make_synthetic_env(6, n_events=20_000, n_campaigns=24, emb_dim=6,
                             device="cpu")
    for kind in ("first_price", "second_price"):
        rule = AuctionRule(multipliers=env.rule.multipliers * 1.1,
                           reserve=torch.tensor(0.02), kind=kind)
        want = CounterfactualEngine(env.values, env.budgets * 0.4, rule,
                                    device="cpu").simulate(
            method="naive_sampling", sample_size=500)
        cuda_cs.reset_launches()
        got = CounterfactualEngine(env.values, env.budgets * 0.4,
                                   _on(dev, rule), device=dev).simulate(
            method="naive_sampling", sample_size=500)
        torch.cuda.synchronize()
        assert cuda_cs.LAUNCHES["capped_scan"] == 1
        assert torch.equal(got.final_spend.cpu(), want.final_spend)
        assert torch.equal(got.cap_times.cpu(), want.cap_times)
        assert int((want.cap_times <= 20_000).sum()) > 0


@pytest.mark.parametrize("resolve", ["auto", "sweep_resolve", "torch"])
def test_chunked_sweeps_on_the_card_are_the_cpu(dev, resolve):
    """Event and scenario chunks on every back-end on the card: the six
    outputs of the CPU's unchunked sweep; the fused back-end makes two
    ``sweep_partials`` launches a chunk a round and no ``round_fused``."""
    env, budgets, rules = _grid_env()
    want = sweep_state_machine(env.values, budgets, rules, resolve="torch")
    cuda_rf.reset_launches()
    got = sweep_state_machine(env.values.to(dev), budgets.to(dev),
                              _on(dev, rules), resolve=resolve, chunks=1024)
    torch.cuda.synchronize()
    rounds = int(want[4].max())
    if resolve == "auto":
        assert cuda_rf.LAUNCHES["round_fused"] == 0
        assert cuda_rf.LAUNCHES["sweep_partials"] == 2 * 4 * rounds
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    got = sweep_state_machine(env.values.to(dev), budgets.to(dev),
                              _on(dev, rules), resolve=resolve, chunks=512,
                              scenario_chunks=1)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_chunked_s2a_sweep_on_the_card_is_the_cpu(dev):
    env, budgets, rules = _grid_env()
    kw = dict(refine_iters=3, chunks=1024, crossing_block=256)
    want = executor.execute_s2a_sweep(env.values, budgets, rules,
                                      executor.SweepPlan(chunks=1024),
                                      refine_iters=3, crossing_block=256)
    cuda_sg.reset_launches()
    cuda_fc.reset_launches()
    got = sweep_sort2aggregate(env.values.to(dev), budgets.to(dev),
                               _on(dev, rules), **kw)
    torch.cuda.synchronize()
    assert cuda_sg.LAUNCHES["segment_resolve"] == \
        cuda_fc.LAUNCHES["first_crossing"] == 4 * 4
    for a, b in zip((got[0].final_spend, got[0].cap_times, got[1], got[2]),
                    (want[0].final_spend, want[0].cap_times, want[1],
                     want[2])):
        assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# CRN scenario families: the draws, the bid noise, the VI and the sweeps
# ---------------------------------------------------------------------------

from repro_torch import scenarios as sc  # noqa: E402
from repro_torch.core import crn  # noqa: E402
from repro_torch.kernels import crn as cuda_crn  # noqa: E402


@pytest.mark.parametrize("normal", [True, False])
@pytest.mark.parametrize("scattered", [False, True])
def test_crn_cells_kernel_is_the_cpu(dev, normal, scattered):
    """One ``crn_cells`` launch draws the CPU's bits, from a key made on
    the CPU, at a range of global events or at scattered ones."""
    n, c = 3001, 37
    idx = torch.arange(250_000, 250_000 + n)
    if scattered:
        idx = torch.from_numpy(np.random.default_rng(1).permutation(
            1_000_000)[:n].astype(np.int64))
    key = crn.stream_key(prng.PRNGKey(8), "bid_noise")
    draw = crn.event_campaign_normals if normal else \
        crn.event_campaign_uniforms
    want = draw(key, idx, c)
    cuda_crn.reset_launches()
    got = draw(key, idx.to(dev), c)
    torch.cuda.synchronize()
    assert cuda_crn.LAUNCHES["crn_cells"] == 1
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def test_bid_noise_kernel_is_the_cpu(dev):
    rng = np.random.default_rng(2)
    s, t, c = 3, 5000, 41
    v = torch.from_numpy(rng.uniform(0, 1, (t, c)).astype(np.float32))
    z = crn.event_campaign_normals(prng.PRNGKey(1), torch.arange(t), c)
    sigma = torch.from_numpy(rng.uniform(0, 1.5, (s, c)).astype(np.float32))
    sigma[0] = 0.0
    want = cuda_crn.bid_noise(v, z, sigma)
    cuda_crn.reset_launches()
    got = cuda_crn.bid_noise(v.to(dev), z.to(dev), sigma.to(dev))
    torch.cuda.synchronize()
    assert cuda_crn.LAUNCHES["bid_noise"] == 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want[0], v)


def _family_engines(dev, n=4096, c=16):
    env = make_synthetic_env(9, n_events=n, n_campaigns=c, emb_dim=6,
                             device="cpu")
    return {str(where): CounterfactualEngine(
        env.values, env.budgets, AuctionRule.first_price(c, device=where),
        device=where) for where in ("cpu", dev)}


def _family(engine, specs, seed=5):
    return sc.compile_family(engine.values, engine.budgets,
                             engine.base_rule, specs,
                             key=prng.PRNGKey(seed))


STATIC_SPECS = [sc.PauseCampaign(3), sc.BoostCampaign(1, 1.5),
                [sc.ScaleBudgets(0.5), sc.SetReserve(0.02)],
                sc.AddEntrant(budget=3.0, value_scale=0.9)]
PER_EVENT_SPECS = [sc.BidNoise(0.2), sc.ParticipationJitter(0.9),
                   sc.BudgetPacing(2, 1000, 3000),
                   [sc.BidNoise(0.2), sc.BudgetPacing(2, 1000, 3000)],
                   [sc.BidNoise(0.0), sc.ParticipationJitter(1.0)]]


@pytest.mark.parametrize("resolve", ["auto", "sweep_resolve", "torch"])
def test_static_family_on_the_card_is_the_cpu(dev, resolve):
    """A static family (pauses, boosts, budgets, a reserve, a full-window
    entrant) on every back-end on the card, chunked too: the CPU's bits;
    ``"auto"`` takes the fused round kernel."""
    engines = _family_engines(dev)
    want = engines["cpu"].sweep(_family(engines["cpu"], STATIC_SPECS),
                                resolve="torch")
    fam = _family(engines[str(dev)], STATIC_SPECS)
    assert fam.values.shape[1] == 17 and not fam.overlay.per_event
    cuda_rf.reset_launches()
    for kw in (dict(), dict(chunks=1024)):
        got = engines[str(dev)].sweep(fam, resolve=resolve, **kw)
        assert torch.equal(got.results.final_spend.cpu(),
                           want.results.final_spend)
        assert torch.equal(got.results.cap_times.cpu(),
                           want.results.cap_times)
    if resolve == "auto":
        assert cuda_rf.LAUNCHES["round_fused"] > 0
    assert float(want.results.final_spend[1, 3]) == 0.0


def test_per_event_family_on_the_card_is_the_cpu(dev):
    """Bid noise, participation and a pacing window on ``resolve="torch"``
    on the card (one ``bid_noise`` launch a noisy lane a round, the
    partials through ``segment_partials``), chunked too: the CPU's bits;
    the kernel back-ends refuse the family."""
    engines = _family_engines(dev)
    want = engines["cpu"].sweep(_family(engines["cpu"], PER_EVENT_SPECS),
                                resolve="torch")
    fam = _family(engines[str(dev)], PER_EVENT_SPECS)
    assert fam.overlay.per_event
    cuda_crn.reset_launches()
    cuda_sp.reset_launches()
    for kw in (dict(), dict(chunks=1024, scenario_chunks=2)):
        got = engines[str(dev)].sweep(fam, resolve="torch", **kw)
        assert torch.equal(got.results.final_spend.cpu(),
                           want.results.final_spend)
        assert torch.equal(got.results.cap_times.cpu(),
                           want.results.cap_times)
    assert cuda_crn.LAUNCHES["crn_cells"] == 4
    assert cuda_crn.LAUNCHES["bid_noise"] > 0
    assert cuda_sp.LAUNCHES["segment_partials"] > 0
    assert torch.equal(want.results.final_spend[5],
                       want.results.final_spend[0])
    for resolve in ("auto", "fused", "sweep_resolve"):
        with pytest.raises(ValueError, match="torch resolve path only"):
            engines[str(dev)].sweep(fam, resolve=resolve)


@pytest.mark.parametrize("c", [16, "device_state"])
def test_vi_kernel_with_an_overlay_is_the_cpu(dev, c):
    """estimate_pi_sweep with a per-event overlay: every lane's perturbed
    rows and eligibility in one vi launch, the CPU's lane loop bit for bit
    (also where the staged state with the mask does not fit in shared
    memory)."""
    if c == "device_state":
        c = 16
        while cuda_vi.staged(64, c + 1, 1, True):
            c += 1
        c += 1
    engines = _family_engines(dev, c=c)
    out, staged = {}, None
    for where, eng in engines.items():
        fam = _family(eng, PER_EVENT_SPECS)
        cuda_vi.reset_launches()
        out[where] = vi.estimate_pi_sweep(
            fam.values, fam.grid.budgets, fam.grid.rules,
            prng.PRNGKey(4), overlay=fam.overlay, sample_size=400,
            num_iters=3, batch_size=64)
        staged = dict(cuda_vi.LAUNCHES)
    assert staged["vi"] == 1
    assert staged["vi_device_state"] == int(not cuda_vi.staged(64, c, 1,
                                                                True))
    assert torch.equal(out[str(dev)].pi.cpu(), out["cpu"].pi)


def test_draws_follow_the_values_not_the_key(dev):
    """Naive sampling's permutation and a family's CRN draws run on the
    card when the values are there, from a key made on the CPU, and give
    the CPU's bits."""
    values = torch.rand(5000, 8)
    key = prng.PRNGKey(3)
    want = prng.choice(key, 5000, 700)
    got = prng.choice(key.to(dev), 5000, 700)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    eng = CounterfactualEngine(values, torch.full((8,), 5.0), device=dev)
    res = eng.simulate(method="naive_sampling", sample_size=700, key=key)
    ref_res = CounterfactualEngine(values, torch.full((8,), 5.0),
                                   device="cpu").simulate(
        method="naive_sampling", sample_size=700, key=key)
    assert torch.equal(res.final_spend.cpu(), ref_res.final_spend)
    z = crn.event_campaign_normals(key, torch.arange(5000, device=dev), 8)
    assert z.device.type == "cuda"


# ---------------------------------------------------------------------------
# The service's paths: host-streamed logs, resumable folds
# ---------------------------------------------------------------------------

def _day(n, c, seed=6):
    env = make_synthetic_env(seed, n_events=n, n_campaigns=c, emb_dim=8,
                             device="cpu")
    budgets = torch.stack([env.budgets * m for m in (1.0, 0.6, 1.4, 0.8)])
    mult = torch.stack([env.rule.multipliers * m
                        for m in (1.0, 1.2, 0.9, 1.1)])
    return env.values, budgets, mult


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_host_streamed_sweep_is_the_device_chunked_sweep(dev, prefetch,
                                                         kind):
    """A log of three pinned slabs streamed to the card in chunks of 4,096
    (one chunk straddles two slabs and is staged), with and without the
    copy stream: every output bitwise the device-resident chunked sweep
    and the unchunked fused one; two ``sweep_partials`` launches a chunk
    a round, and every chunk of every pass copied once."""
    values, budgets, mult = _day(32_768, 24)
    rules = AuctionRule(multipliers=mult.to(dev),
                        reserve=torch.tensor([0.0, 0.02, 0.0, 0.05],
                                             device=dev), kind=kind)
    b = budgets.to(dev)
    want = executor.execute_sweep(values.to(dev), b, rules,
                                  executor.SweepPlan(chunks=4096))
    fused = executor.execute_sweep(values.to(dev), b, rules,
                                   executor.SweepPlan())
    stream = executor.HostStream([values[:10_000], values[10_000:18_000],
                                  values[18_000:]])
    assert all(s.is_pinned() for s in stream._slabs)
    executor.reset_h2d()
    cuda_rf.reset_launches()
    got = executor.execute_sweep(stream, b, rules, executor.SweepPlan(
        chunks=executor.ChunkSpec(4096, source="host", prefetch=prefetch)))
    torch.cuda.synchronize()
    rounds = int(got[4].max())
    for a, w, f in zip(got, want, fused):
        assert a.device.type == "cuda"
        assert torch.equal(a, w) and torch.equal(a, f)
    assert cuda_rf.LAUNCHES["sweep_partials"] == 2 * 8 * rounds
    assert executor.H2D["copies"] == 2 * 8 * rounds
    assert executor.H2D["bytes"] == 2 * rounds * 32_768 * 24 * 4
    # chunks 2 and 4 ([8192, 12288) and [16384, 20480)) straddle slabs
    assert executor.H2D["staged"] == 2 * 2 * rounds


@pytest.mark.parametrize("resolve", ["fused", "torch", "sweep_resolve"])
def test_mid_block_fold_is_the_cpu_fold(dev, resolve):
    """Folds of 12,000, 9,000 and 11,768 rows of a 32,768-event day: the
    second starts inside block 18 of the grown log's 657-event grid, the
    third inside block 20 of 1,024. Every fold's outputs and carry on the
    card bitwise the CPU's plain fold; the fused back-end makes no
    ``round_fused`` launch after the first fold."""
    values, budgets, mult = _day(32_768, 24, seed=7)
    rules_cpu = AuctionRule(multipliers=mult, reserve=torch.zeros(4),
                            kind="second_price")
    rules = AuctionRule(multipliers=mult.to(dev),
                        reserve=torch.zeros(4, device=dev),
                        kind="second_price")
    carry = carry_cpu = None
    start = 0
    for n in (12_000, 9_000, 11_768):
        cuda_rf.reset_launches()
        out, carry = executor.execute_sweep_resumable(
            values[start:start + n].to(dev), budgets.to(dev), rules,
            executor.SweepPlan(resolve=resolve), carry=carry)
        torch.cuda.synchronize()
        if resolve == "fused" and start:
            assert cuda_rf.LAUNCHES["round_fused"] == 0
            assert cuda_rf.LAUNCHES["sweep_partials"] == 2 * int(
                out[4].max())
        want, carry_cpu = executor.execute_sweep_resumable(
            values[start:start + n], budgets, rules_cpu,
            executor.SweepPlan(resolve="torch"), carry=carry_cpu)
        for a, b in zip(out, want):
            assert torch.equal(a.cpu(), b)
        start += n
    assert carry.n_events_seen == carry_cpu.n_events_seen == 32_768
    for name in ("s_hat", "active", "cap_times", "n_hat"):
        assert torch.equal(getattr(carry, name).cpu(),
                           getattr(carry_cpu, name))


def test_straddling_chunk_is_staged_in_pinned_memory(dev):
    """A chunk across two slabs is put together in the pipeline's pinned
    staging buffer and copied from there asynchronously: the rows on the
    card are the log's, and a slab that was not pinned is pinned once."""
    values = torch.rand(3000, 5)
    stream = executor.HostStream([values[:1700], values[1700:]])
    assert all(s.is_pinned() for s in stream._slabs)
    pipe = executor._HostPipeline(stream, 1000, 500, dev, prefetch=True)
    executor.reset_h2d()
    seen = []
    for offset, rows in pipe.rows():
        seen.append((offset, rows.clone()))
    torch.cuda.synchronize()
    assert [o for o, _ in seen] == [500, 1500, 2500]
    for k, (_, rows) in enumerate(seen):
        assert torch.equal(rows.cpu(), values[k * 1000:(k + 1) * 1000])
    assert executor.H2D == {"copies": 3, "bytes": 3 * 1000 * 5 * 4,
                            "staged": 1}
    assert pipe.staging[1] is not None and pipe.staging[1].is_pinned()


# ---------------------------------------------------------------------------
# The multi-GPU placements: several event shards on one card
# ---------------------------------------------------------------------------

from repro_torch.core import sharded  # noqa: E402
from repro_torch.launch.mesh import SweepMeshSpec, make_mesh  # noqa: E402


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
@pytest.mark.parametrize("resolve", ["fused", "sweep_resolve", "torch"])
def test_sharded_sweep_on_one_card_is_the_batched_sweep(dev, resolve, shape):
    """Four event shards on ``cuda:0`` (views of one tensor), and a 2 × 2
    event × scenario mesh: the six outputs of the CPU's batched sweep, bit
    for bit; the fused back-end makes two ``sweep_partials`` launches a
    shard a round and no ``round_fused``."""
    env, budgets, rules = _grid_env()
    budgets, rules = torch.cat([budgets, budgets[:1]]), AuctionRule(
        multipliers=torch.cat([rules.multipliers, rules.multipliers[:1]]),
        reserve=torch.cat([rules.reserve, rules.reserve[:1]]),
        kind=rules.kind)
    want = sweep_state_machine(env.values, budgets, rules, resolve="torch")
    spec = SweepMeshSpec.for_devices(*shape, devices=[dev] * 4)
    cuda_rf.reset_launches()
    got = sweep_state_machine(env.values.to(dev), budgets.to(dev),
                              _on(dev, rules), resolve=resolve,
                              driver="sharded", mesh=spec)
    torch.cuda.synchronize()
    if resolve == "fused":
        shards = spec.event_device_count
        rounds = sum(int(got[4][g * 2:(g + 1) * 2].max())
                     for g in range(2)) if len(shape) == 2 \
            else int(got[4].max())
        assert cuda_rf.LAUNCHES["round_fused"] == 0
        assert cuda_rf.LAUNCHES["sweep_partials"] == 2 * shards * rounds
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_sharded_s2a_and_vi_on_one_card_are_the_cpu(dev):
    """The sharded SORT2AGGREGATE sweep (one ``segment_resolve`` launch and
    one ``first_crossing`` call with a carry at ``block = local_n`` a shard
    a pass) and Algorithm 4 at scale (a MatrixTile resolve and a flat sum
    a step) on four shards of one card: the CPU's mesh, bit for bit."""
    env, budgets, rules = _grid_env()
    cpu = SweepMeshSpec.for_devices(devices=["cpu"] * 4)
    card = SweepMeshSpec.for_devices(devices=[dev] * 4)
    want = sharded.sweep_sort2aggregate_sharded(env.values, budgets, rules,
                                                cpu, refine_iters=3)
    cuda_sg.reset_launches()
    cuda_fc.reset_launches()
    got = sharded.sweep_sort2aggregate_sharded(
        env.values.to(dev), budgets.to(dev), _on(dev, rules), card,
        refine_iters=3)
    torch.cuda.synchronize()
    assert cuda_sg.LAUNCHES["segment_resolve"] == \
        cuda_fc.LAUNCHES["first_crossing"] == 4 * 4
    for a, b in zip((got[0].final_spend, got[0].cap_times, got[1], got[2]),
                    (want[0].final_spend, want[0].cap_times, want[1],
                     want[2])):
        assert torch.equal(a.cpu(), b)
    rule = AuctionRule(multipliers=rules.multipliers[1],
                       reserve=rules.reserve[1], kind=rules.kind)
    key = prng.PRNGKey(3)
    pi_cpu = sharded.estimate_pi_sharded(cpu.mesh, env.values, budgets[1],
                                         rule, key, num_iters=50)
    pi_card = sharded.estimate_pi_sharded(
        card.mesh, env.values.to(dev), budgets[1].to(dev),
        _on(dev, rule), key, num_iters=50)
    assert torch.equal(pi_card.cpu(), pi_cpu)


# ---------------------------------------------------------------------------
# plan tuning and the keyed days
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resolve", ["fused", "sweep_resolve", "torch"])
def test_tuned_sweep_on_the_card_is_the_untuned_sweep(dev, resolve,
                                                      tmp_path, monkeypatch):
    """A tuned plan on the card (the cost model's choice, then a cached
    winner that chunks events and scenarios) gives the untuned sweep's six
    outputs bit for bit."""
    from repro_torch import tune
    from repro_torch.tune import space
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "tune.json"))
    env, budgets, rules = _grid_env()
    budgets = torch.cat([budgets, budgets[:1]]).to(dev)
    rules = _on(dev, AuctionRule(
        multipliers=torch.cat([rules.multipliers, rules.multipliers[:1]]),
        reserve=torch.cat([rules.reserve, rules.reserve[:1]]),
        kind=rules.kind))
    values = env.values.to(dev)
    base = executor.SweepPlan(resolve=resolve)
    tuned = executor.SweepPlan(resolve=resolve, block_t="auto", tuned=True)
    want = executor.execute_sweep(values, budgets, rules, base)
    for a, b in zip(executor.execute_sweep(values, budgets, rules, tuned),
                    want):
        assert torch.equal(a, b)
    shape = tune.shape_for(tuned, n_events=4096, n_campaigns=16,
                           n_scenarios=4, device=dev)
    winner = space.Candidate(events_per_chunk=1024, scenarios_per_chunk=2,
                             skip_retired=False)
    assert space.is_legal(winner, tuned, shape)
    cache = tune.TuningCache.load(tmp_path / "tune.json")
    cache.put(tune.cache_key(shape), winner.config())
    cache.save()
    for a, b in zip(executor.execute_sweep(values, budgets, rules, tuned),
                    want):
        assert torch.equal(a, b)


def test_rank_candidates_on_the_card_with_real_limits(dev):
    """The lattice on the card with the real ``round_campaign_limits()``:
    the §7.1 day's C fits the fused round, so the fused lattice frees
    ``skip_retired`` and ranks the one-launch round first; a C past the
    limit goes to the any-C back-end."""
    from repro_torch import tune
    from repro_torch.kernels.auction_resolve import ops as ops_
    plan = executor.SweepPlan(block_t="auto", tuned=True)
    shape = tune.shape_for(plan, n_events=1_000_000, n_campaigns=100,
                           n_scenarios=32, device=dev)
    assert shape.resolve == "fused" and shape.platform == "cuda"
    ranked = tune.rank_candidates(plan, shape)
    assert {c.skip_retired for c, _ in ranked} == {True, False}
    assert ranked[0][0].events_per_chunk is None
    assert ranked[0][0].scenarios_per_chunk is None
    wide = ops_.round_campaign_limits()["fused"] + 1
    assert tune.shape_for(plan, n_events=4096, n_campaigns=wide,
                          n_scenarios=4, device=dev).resolve == \
        executor.ANY_C_BACKEND


@pytest.mark.parametrize("n,c,d,block", [
    (5000, 16, 10, 2048), (3000, 100, 10, 1024), (2048, 37, 6, 1000)])
def test_keyed_day_on_the_card_is_the_cpus(dev, n, c, d, block):
    """The keyed synthetic day built on the card (draws, the dot in XLA's
    order, ``floats.exp``) is the CPU's keyed day bit for bit."""
    want = make_synthetic_env(prng.PRNGKey(7), n_events=n, n_campaigns=c,
                              emb_dim=d, block=block, device="cpu")
    got = make_synthetic_env(prng.PRNGKey(7), n_events=n, n_campaigns=c,
                             emb_dim=d, block=block, device=dev)
    for name in ("values", "event_emb", "campaign_emb", "budgets"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name


def test_yahoo_env_on_the_card_is_the_cpus(dev):
    """The Yahoo-like day built on the card is the CPU's bit for bit: the
    bid table, both days' keywords and valuations."""
    from repro_torch.data import make_yahoo_like_env
    kw = dict(n_keywords=1000, n_campaigns=40, n_day1=4096, n_day2=6144,
              budget=12.0)
    want = make_yahoo_like_env(prng.PRNGKey(0), device="cpu", **kw)
    got = make_yahoo_like_env(prng.PRNGKey(0), device=dev, **kw)
    for name in ("bid_table", "day1_keywords", "day2_keywords", "budgets"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    assert torch.equal(got.values(2).cpu(), want.values(2))


@pytest.mark.parametrize("n", [1, 257, 100_003])
def test_comm_quantisation_on_the_card_is_the_cpus(dev, n):
    """``comm``'s int8 block quantisation and error feedback on the card
    give the CPU's bits (a divide by a host scalar would be CUDA's multiply
    by its reciprocal)."""
    from repro_torch import comm
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)) * 1e3
    err = torch.randn(n, generator=torch.Generator().manual_seed(1)) * 1e-2
    for got, want in zip(comm.compress_with_feedback(x.to(dev), err.to(dev)),
                         comm.compress_with_feedback(x, err)):
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def test_flash_wrappers_on_meta_launch_nothing(dev):
    """The dry run's meta route: the forward and backward wrappers return
    empty outputs of their kernels' shapes and dtypes, launch no kernel
    and allocate no card memory."""
    meta = torch.device("meta")
    q = torch.empty((2, 256, 8, 64), dtype=torch.bfloat16, device=meta,
                    requires_grad=True)
    k = torch.empty((2, 256, 2, 64), dtype=torch.bfloat16, device=meta,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    fwd, bwd = dict(cuda_fa.LAUNCHES), dict(cuda_fab.LAUNCHES)
    allocated = torch.cuda.memory_allocated(dev)
    out = fa_ops.flash_attention(q, k, v, causal=True, window=None)
    assert (out.shape, out.dtype, out.device) == (q.shape, q.dtype, meta)
    out.sum().backward()
    for t, g in ((q, q.grad), (k, k.grad), (v, v.grad)):
        assert (g.shape, g.dtype, g.device) == (t.shape, t.dtype, meta)
    with torch.no_grad():
        served = fa_ops.flash_attention(q, k, v, causal=False, window=64)
    assert served.shape == q.shape and served.device == meta
    assert dict(cuda_fa.LAUNCHES) == fwd and dict(cuda_fab.LAUNCHES) == bwd
    assert torch.cuda.memory_allocated(dev) == allocated
