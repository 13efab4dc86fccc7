"""The segment replay of SORT2AGGREGATE (``csrc/segment_resolve.cu``'s
function) on the CPU: the kernel's split (``ref.segment_resolve_ref``: 128-row
tiles, 32 lanes at a time, a lane's first piece and each piece after a
boundary inside a tile) against the plain version (each lane's gathered
(N, C) mask and one resolve), against ``resolve_masked`` lane by lane and
against ``repro``'s ``segments.aggregate``, bit for bit. The tables put
boundaries on tile edges, repeat them, cap at event 1 and at N, leave
campaigns uncapped, and (hand-built) give masks that are not monotone."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import Segments as JSegments  # noqa: E402
from repro.core import segments as j_seg  # noqa: E402
from repro_torch.core import AuctionRule, Segments, segments  # noqa: E402
from repro_torch.core.sort2aggregate import _replay_lanes  # noqa: E402
from repro_torch.kernels.auction_resolve import ops, ref  # noqa: E402
from repro_torch.kernels.auction_resolve.segment_resolve import (  # noqa: E402
    segment_resolve_cuda)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, C = 1000, 12
TILE = ref.SEGMENT_TILE
KINDS = ("first_price", "second_price")


def _cap_table(case, s, rng):
    """(S, C) 1-based cap times of one case."""
    caps = rng.integers(1, N + 1, (s, C))
    if case == "tile_edges":            # boundaries on tile edges and +-1
        edges = np.array([TILE, 2 * TILE, 3 * TILE + 1, 4 * TILE - 1,
                          7 * TILE, N - 1])
        caps = edges[rng.integers(0, len(edges), (s, C))]
    elif case == "duplicates":          # many campaigns capping together
        caps = rng.choice([200, 200, 513, 513, 513, 900], (s, C))
    elif case == "cap_at_1_and_n":
        caps[:, 0], caps[:, 1], caps[:, 2] = 1, N, N + 1
        caps[:, 3] = 10 * N                 # never caps
        caps[::2, 4:7] = 1
    return caps.astype(np.int32)


def _hand_built(s, rng):
    """(S, K+2) sorted boundaries with 0 and N among the inner ones and
    duplicates, and (S, K+1, C) masks with no order between segments."""
    k = 9
    inner = np.sort(np.concatenate(
        [rng.integers(0, N + 1, (s, k - 3)),
         np.tile([0, TILE, N], (s, 1))], axis=1), axis=1)
    bounds = np.concatenate([np.zeros((s, 1)), inner, np.full((s, 1), N)],
                            axis=1).astype(np.int32)
    masks = rng.uniform(size=(s, k + 1, C)) < 0.6
    return torch.from_numpy(bounds), torch.from_numpy(masks)


def _inputs(case, s, seed):
    rng = np.random.default_rng(seed)
    # coarse values, so equal bids and ties across columns are common
    values = (rng.integers(0, 8, (N, C)) / 8).astype(np.float32)
    mult = rng.choice([0.5, 1.0, 1.5], (s, C)).astype(np.float32)
    res = rng.choice([0.0, 0.125, 0.3], s).astype(np.float32)
    if case == "hand_built":
        bounds, masks = _hand_built(s, rng)
    else:
        segs = Segments.from_cap_times(
            torch.from_numpy(_cap_table(case, s, rng)), N)
        bounds, masks = segs.boundaries, segs.masks
    return (torch.from_numpy(values), torch.from_numpy(mult),
            torch.from_numpy(res), bounds, masks)


CASES = ("tile_edges", "duplicates", "cap_at_1_and_n", "hand_built")


@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASES)
def test_segment_resolve_ref_is_the_plain_version(case, kind, s):
    """The kernel's split gives the gathered-mask resolve's bits, lane by
    lane, and covers every row (an uncovered row would keep winner -2)."""
    values, mult, res, bounds, masks = _inputs(case, s, seed=CASES.index(
        case) * 100 + s)
    sp = kind == "second_price"
    want = ref.segment_resolve_plain(values, mult, res, bounds, masks, sp)
    got = ref.segment_resolve_ref(values, mult, res, bounds, masks, sp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((want[0] >= -1).all()) and bool((want[0] >= 0).any())
    for lane in (0, s - 1):
        seg_ids = Segments(boundaries=bounds[lane],
                           masks=masks[lane]).seg_ids(N)
        w, p, _ = ops.resolve_masked(values, mult[lane],
                                     masks[lane][seg_ids], res[lane],
                                     second_price=sp, sums=False)
        assert torch.equal(w, want[0][lane]) and torch.equal(p, want[1][lane])
    on_cpu = ops.segment_resolve(values, mult, res, bounds, masks,
                                 second_price=sp)
    for a, b in zip(on_cpu, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [0, 300])
@pytest.mark.parametrize("n_ctas", [1, 3, 7])
@pytest.mark.parametrize("s", [1, 33])
@pytest.mark.parametrize("case", ["tile_edges", "hand_built"])
def test_segment_resolve_ref_runs_of_tiles(case, s, n_ctas, offset):
    """The persistent grid's split: each CTA a run of tiles carrying every
    lane's segment and next boundary from tile to tile (runs of 2 or 3
    tiles, one run of all 8), at a row offset too, is the plain version's
    bits, second price."""
    values, mult, res, bounds, masks = _inputs(case, s, seed=41 + s)
    rows = slice(offset, N)
    want = ref.segment_resolve_plain(values[rows], mult, res, bounds, masks,
                                     True, offset=offset)
    got = ref.segment_resolve_ref(values[rows], mult, res, bounds, masks,
                                  True, n_ctas=n_ctas, offset=offset)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", CASES)
def test_segment_resolve_is_the_reference_aggregate(case, kind):
    """Three lanes of a table against ``repro``'s ``segments.aggregate``
    (its winners and prices, the resolve under ``masks[seg_ids]``)."""
    values, mult, res, bounds, masks = _inputs(case, 3, seed=7)
    sp = kind == "second_price"
    got = ref.segment_resolve_ref(values, mult, res, bounds, masks, sp)
    for lane in range(3):
        rule = JRule(multipliers=jnp.asarray(mult[lane].numpy()),
                     reserve=jnp.float32(res[lane].item()), kind=kind)
        want = j_seg.aggregate(
            jnp.asarray(values.numpy()),
            JSegments(boundaries=jnp.asarray(bounds[lane].numpy()),
                      masks=jnp.asarray(masks[lane].numpy())),
            jnp.full((C,), 1e9, jnp.float32), rule)
        np.testing.assert_array_equal(got[0][lane].numpy(),
                                      np.asarray(want.winners))
        np.testing.assert_array_equal(got[1][lane].numpy(),
                                      np.asarray(want.prices))


@pytest.mark.parametrize("kind", KINDS)
def test_replay_lanes_is_each_lanes_aggregate(kind):
    """A batched replay pass (all lanes in one ``ops.segment_resolve``) is
    each lane's single-lane ``segments.aggregate``, bit for bit."""
    rng = np.random.default_rng(11)
    values, mult, res, _, _ = _inputs("duplicates", 4, seed=11)
    caps = torch.from_numpy(_cap_table("tile_edges", 4, rng))
    budgets = torch.from_numpy(rng.uniform(5, 40, (4, C)).astype(np.float32))
    rules = AuctionRule(multipliers=mult, reserve=res, kind=kind)
    spend, cap, winners, prices = _replay_lanes(values, caps, budgets, rules,
                                                crossing_block=4096)
    for lane in range(4):
        one = segments.aggregate(
            values, Segments.from_cap_times(caps[lane], N), budgets[lane],
            AuctionRule(multipliers=mult[lane], reserve=res[lane],
                        kind=kind))
        for a, b in ((spend, one.final_spend), (cap, one.cap_times),
                     (winners, one.winners), (prices, one.prices)):
            assert torch.equal(a[lane], b)


def test_segment_resolve_cuda_refuses_cpu_tensors():
    values, mult, res, bounds, masks = _inputs("duplicates", 2, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_resolve_cuda(values, mult, res, bounds, masks,
                             second_price=False)
