"""The paths the CUDA entry points take above their kernels' campaign
limits, on the CPU with the limits passed in small: the round back-end
that gives way to the any-C ``auction_resolve`` one (``pick_resolve``:
every lane of a round in one ``ops.resolve_lanes`` call), which gives the
torch back-end's bits, the campaign-chunked
``segment_partials`` (its winner remap) and the campaign-chunked EmbTile
resolve (its exact merge), each bitwise the unchunked plain version. The
kernels at their real limits are held on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import auction, executor, pick_resolve, segments  # noqa: E402,E501
from repro_torch.core.types import AuctionRule  # noqa: E402
from repro_torch.data import make_synthetic_env  # noqa: E402
from repro_torch.kernels.auction_resolve import ref  # noqa: E402
from repro_torch.kernels.auction_resolve.ops import \
    resolve_by_campaign_chunks  # noqa: E402
from repro_torch.kernels.auction_resolve.segment_partials import \
    by_campaign_chunks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LIMITS = {"fused": 50, "sweep_resolve": 60}


ANY = executor.ANY_C_BACKEND


@pytest.mark.parametrize("resolve,c,want", [
    ("auto", 50, "fused"), ("auto", 51, ANY),
    ("fused", 50, "fused"), ("fused", 51, ANY),
    ("sweep_resolve", 60, "sweep_resolve"), ("sweep_resolve", 61, ANY),
    ("torch", 10_000, "torch"),
])
def test_pick_resolve_gives_way_above_a_kernel_limit(resolve, c, want):
    """On CUDA a back-end whose kernel cannot hold C campaigns becomes the
    any-C ``auction_resolve`` back-end, asked for or picked by
    ``"auto"``; the CPU runs the plain versions, which have no limit, and a
    call without C is not gated."""
    assert pick_resolve(resolve, "cuda", c, limits=LIMITS) == want
    assert pick_resolve(resolve, "cpu", c, limits=LIMITS) == (
        "torch" if resolve == "auto" else resolve)
    assert pick_resolve(resolve, "cuda", limits=LIMITS) == (
        "fused" if resolve == "auto" else resolve)


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_any_c_backend_is_the_torch_back_end(kind, monkeypatch):
    """The round body of the back-end a C above the round kernels' limits
    takes (every lane of a round through one ``ops.resolve_lanes`` call,
    on the CPU its plain version) runs Algorithm 2 to the torch
    back-end's bits."""
    calls = []
    lanes = executor.resolve_ops.resolve_lanes

    def spy(values, multipliers, active, reserves, **kw):
        calls.append(tuple(active.shape))
        return lanes(values, multipliers, active, reserves, **kw)

    monkeypatch.setattr(executor.resolve_ops, "resolve_lanes", spy)
    env = make_synthetic_env(2, n_events=3000, n_campaigns=24, emb_dim=8,
                             device="cpu")
    budgets = torch.stack([env.budgets, env.budgets * 0.6])
    rules = AuctionRule(
        multipliers=torch.stack([env.rule.multipliers,
                                 env.rule.multipliers * 1.1]),
        reserve=torch.tensor([0.0, 0.04]), kind=kind)
    plan = executor.SweepPlan()
    out = {}
    for resolve in ("torch", ANY):
        body = executor._make_round_body(
            plan, resolve, values=env.values, rules=rules,
            budgets_f32=budgets, n_events=3000, n_campaigns=24)
        out[resolve] = executor._run_loop(body, n_scenarios=2,
                                          n_events=3000, n_campaigns=24,
                                          device=env.values.device)
    for a, b in zip(out[ANY], out["torch"]):
        assert torch.equal(a, b)
    assert bool((out[ANY][2] <= 3000).any())
    rounds = int(out[ANY][4].max())
    assert calls == [(2, 24)] * rounds


def _log(s, n, c, seed):
    rng = np.random.default_rng(seed)
    winners = rng.integers(-1, c, (s, n)).astype(np.int32)
    prices = rng.uniform(0.01, 1.0, (s, n)).astype(np.float32)
    return torch.from_numpy(winners), torch.from_numpy(prices)


@pytest.mark.parametrize("chunk", [1, 7, 36, 37])
def test_segment_partials_campaign_chunks_are_the_whole(chunk):
    """Campaign chunks [c0, c1), each seeing winners ``w - c0`` inside it
    and -1 elsewhere, give the unchunked partials bit for bit: windows per
    lane, a slice at an offset."""
    s, n, c = 3, 2000, 37
    winners, prices = _log(s, n, c, seed=chunk)
    lo = torch.tensor([0, 150, 900], dtype=torch.int32)
    hi = torch.tensor([2500, 1200, 901], dtype=torch.int32)
    kw = dict(block_size=-(-2500 // segments.REDUCE_BLOCKS),
              index_offset=300)
    whole = segments.window_partials_ref(winners, prices, c, lo, hi, **kw)
    calls = []

    def partials(w, cc):
        calls.append(cc)
        assert int(w.max()) < cc and int(w.min()) >= -1
        return segments.window_partials_ref(w, prices, cc, lo, hi, **kw)

    got = by_campaign_chunks(partials, winners, c, chunk)
    assert calls == [min(chunk, c - c0) for c0 in range(0, c, chunk)]
    assert torch.equal(got, whole)


def _emb(n, c, d, per_event, seed):
    """Embeddings whose valuations tie: campaigns repeat in every chunk
    (campaign k + 9 is campaign k) and large dots clip to 1.0."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32) * 2.0
    r = rng.standard_normal((c, d)).astype(np.float32)
    r[9:] = r[:c - 9]
    mult = np.exp(rng.standard_normal(c) * 0.1).astype(np.float32)
    mult[9:] = mult[:c - 9]
    act = rng.uniform(size=(n, c) if per_event else (c,)) < 0.8
    return [torch.from_numpy(x) for x in (e, r, mult, act)]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("per_event", [False, True])
@pytest.mark.parametrize("chunk", [1, 5, 16])
@pytest.mark.parametrize("reserve", [0.03, -0.5])
def test_emb_tile_campaign_chunks_merge_exactly(sp, per_event, chunk,
                                                reserve):
    """EmbTile above its C·d limit: chunks resolved alone (first price for
    each chunk's winner and top bid, second price for its second bid) and
    merged give ``auction_resolve_ref``'s winners and prices bit for bit,
    ties across chunks included, and the flat sums of the merged events
    its sums."""
    n, c, d = 400, 37, 6
    e, r, mult, act = _emb(n, c, d, per_event, seed=chunk)
    res = torch.tensor(reserve)
    want = ref.auction_resolve_ref(e, r, mult, act, res, second_price=sp)

    def resolve(c0, c1, second):
        return ref.auction_resolve_ref(e, r[c0:c1], mult[c0:c1],
                                       act[..., c0:c1], res,
                                       second_price=second)[:2]

    winners, prices = resolve_by_campaign_chunks(resolve, c, chunk, res,
                                                 second_price=sp)
    assert winners.dtype == torch.int32 and prices.dtype == torch.float32
    assert torch.equal(winners, want[0])
    assert torch.equal(prices, want[1])
    assert torch.equal(auction.spend_sums(winners, prices, c), want[2])
    vals = ref.valuations(e, r) * mult
    assert bool((vals == 1.0 * mult).any())          # clipped: tied values
