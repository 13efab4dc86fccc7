"""The single-design resolve's plain versions against ``repro``'s Pallas
kernel (interpret mode) and oracles: the embedding-level
``auction_resolve`` at ``tests/test_kernels.py``'s cases and tolerances,
and the valuation-matrix ``resolve_masked`` bit for bit.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import auction as j_auction  # noqa: E402
from repro.kernels.auction_resolve import auction_resolve as j_resolve  # noqa: E402
from repro.kernels.auction_resolve import auction_resolve_ref as j_resolve_ref  # noqa: E402
from repro.kernels.auction_resolve.ref import resolve_tile_ref  # noqa: E402
from repro_torch.kernels.auction_resolve import ops as t_ops  # noqa: E402
from repro_torch.kernels.auction_resolve import ref as t_ref  # noqa: E402
from repro_torch.kernels.auction_resolve.auction_resolve import (  # noqa: E402
    chunk_plan, resolve_emb_cuda, resolve_lanes_cuda, resolve_matrix_cuda)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _emb_inputs(n, c, d, per_event, seed):
    rng = np.random.default_rng(seed)
    return dict(
        e=rng.standard_normal((n, d)).astype(np.float32),
        r=rng.standard_normal((c, d)).astype(np.float32),
        mult=np.exp(rng.standard_normal(c) * 0.1).astype(np.float32),
        act=rng.uniform(size=(n, c) if per_event else (c,)) < 0.8,
    )


@pytest.mark.parametrize("n,c,d,sp,per_event", [
    (512, 40, 10, False, False),
    (500, 100, 16, True, False),     # ragged N, second price
    (300, 33, 8, False, True),       # ragged everything, per-event mask
    (1024, 128, 128, True, True),    # MXU-aligned
    (256, 7, 4, False, False),       # tiny C
])
def test_auction_resolve_matches_the_pallas_kernel(n, c, d, sp, per_event):
    x = _emb_inputs(n, c, d, per_event, seed=n + c)
    res = np.float32(0.02)
    got = t_ops.auction_resolve(_t(x["e"]), _t(x["r"]), _t(x["mult"]),
                                _t(x["act"]), res, second_price=sp)
    args = (jnp.asarray(x["e"]), jnp.asarray(x["r"]), jnp.asarray(x["mult"]),
            jnp.asarray(x["act"]), jnp.float32(res))
    for want in (j_resolve(*args, second_price=sp),
                 j_resolve_ref(*args, second_price=sp)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auction_resolve_dtypes(dtype):
    x = _emb_inputs(256, 32, 16, False, seed=0)
    e, r = _t(x["e"]).to(dtype), _t(x["r"]).to(dtype)
    ones = torch.ones(32)
    got = t_ops.auction_resolve(e, r, ones, torch.ones(32, dtype=torch.bool))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = j_resolve(jnp.asarray(x["e"]).astype(jdt),
                     jnp.asarray(x["r"]).astype(jdt), jnp.ones(32),
                     jnp.ones(32, bool))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=tol,
                               atol=tol)


def test_valuations_follow_eq_12():
    x = _emb_inputs(64, 9, 10, False, seed=1)
    want = (x["e"].astype(np.float64) @ x["r"].T.astype(np.float64)) \
        / (2 * np.sqrt(10))
    want = np.minimum(np.exp(want) / 10, 1)
    got = t_ref.valuations(_t(x["e"]), _t(x["r"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("per_event", [False, True])
def test_resolve_masked_bitwise_the_reference(sp, per_event):
    n, c = 700, 23
    rng = np.random.default_rng(7 + per_event)
    values = rng.uniform(0.0, 1.0, (n, c)).astype(np.float32)
    mult = rng.uniform(0.5, 1.5, c).astype(np.float32)
    act = rng.uniform(size=(n, c) if per_event else (c,)) < 0.7
    live = rng.uniform(size=n) < 0.9
    res = np.float32(0.05)
    winners, prices, sums = t_ops.resolve_masked(
        _t(values), _t(mult), _t(act), res, _t(live), second_price=sp)
    j_act = (act if per_event else np.broadcast_to(act, (n, c))) \
        & live[:, None]
    w, p, _ = resolve_tile_ref(jnp.asarray(values), jnp.asarray(mult),
                               jnp.asarray(j_act), jnp.float32(res),
                               second_price=sp)
    np.testing.assert_array_equal(winners.numpy(), np.asarray(w))
    np.testing.assert_array_equal(prices.numpy(), np.asarray(p))
    np.testing.assert_array_equal(
        sums.numpy(), np.asarray(j_auction.spend_sums(w, p, c)))
    assert t_ops.resolve_masked(_t(values), _t(mult), _t(act), res,
                                second_price=sp, sums=False)[2] is None


def _tied_lanes(n, c, seed):
    """S=5 lanes of a valuation matrix whose bids tie across campaigns
    (values in eighths, multipliers in {0.5, 1, 1.5}), with inactive
    campaigns, all-ineligible rows (zero valuations) and one lane whose
    reserve is above every bid."""
    rng = np.random.default_rng(seed)
    values = (rng.integers(0, 8, (n, c)) / 8).astype(np.float32)
    values[::17] = 0.0
    mult = rng.choice(np.float32([0.5, 1.0, 1.5]), (5, c))
    act = rng.uniform(size=(5, c)) < 0.7
    act[4, : c // 2] = False
    res = np.float32([0.0, 0.25, 0.5, 10.0, 0.125])
    return _t(values), _t(mult), _t(act), _t(res)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, 23, 64])
def test_chunked_lanes_are_each_lanes_resolve(sp, chunk):
    """The matrix kernel's split on the CPU (``ref.resolve_chunks_ref``:
    per (lane, chunk, row) the scan's best, second and winner; then
    ``ref.merge_chunks_ref``, in ascending chunk order) and the
    plain multi-lane version are, lane by lane, ``resolve_masked_ref``'s
    winners and prices bit for bit: ties across chunk borders, inactive
    (NaN-multiplier) campaigns, rows no campaign bids on, a reserve above
    every bid, chunks of one column, of 7, of C and wider than C."""
    n, c = 300, 23
    values, mult, act, res = _tied_lanes(n, c, seed=chunk)
    got = t_ref.merge_chunks_ref(*t_ref.resolve_chunks_ref(
        values, mult, act, res, chunk_cols=chunk), sp)
    plain = t_ref.resolve_lanes_ref(values, mult, act, res, sp)
    for s in range(5):
        w, p, _ = t_ref.resolve_masked_ref(values, mult[s], act[s], res[s],
                                           second_price=sp)
        for lanes in (got, plain):
            assert torch.equal(lanes[0][s], w) and torch.equal(lanes[1][s], p)
    assert bool((got[0][3] == -1).all()) and bool((got[1][3] == 0).all())
    assert bool((got[0][:, ::17] == -1).all())
    # ties cross chunk borders: equal top bids in two chunks of a row
    bids = values[None] * torch.where(act, mult, 0.0)[:, None]
    top = bids.amax(-1, keepdim=True)
    tied = ((bids == top) & (top > 0)).sum(-1) > 1
    assert bool(tied.any())


@pytest.mark.parametrize("sp", [False, True])
def test_resolve_lanes_is_each_lanes_resolve_masked(sp):
    """``ops.resolve_lanes`` on the CPU (the plain version) is each lane's
    ``ops.resolve_masked`` bit for bit, with a scalar or a per-lane
    reserve."""
    values, mult, act, res = _tied_lanes(200, 40, seed=3)
    for reserves in (res, 0.125):
        w, p = t_ops.resolve_lanes(values, mult, act, reserves,
                                   second_price=sp)
        assert w.dtype == torch.int32 and tuple(w.shape) == (5, 200)
        for s in range(5):
            r = res[s] if isinstance(reserves, torch.Tensor) else reserves
            want = t_ops.resolve_masked(values, mult[s], act[s], r,
                                        second_price=sp, sums=False)
            assert torch.equal(w[s], want[0]) and torch.equal(p[s], want[1])


@pytest.mark.parametrize("n,c,chunks,cols", [
    (512, 15_553, 66, 236),      # the any-C back-end's shape: 4 row tiles
    (65_536, 16_384, 1, 16_384),  # 512 row tiles: one chunk
    (33_665, 100, 1, 100),       # 264 row tiles, 2 x 132
    (33_664, 100, 2, 50),
    (100, 37, 1, 37),            # C below one 64-column window
    (1, 200, 4, 50),             # one row: chunks of a window at least
])
def test_chunk_plan(n, c, chunks, cols):
    """The matrix kernel's campaign chunks on a 132-SM card: enough that
    the row tiles make about 2 x 132 CTAs, none narrower than a 64-column
    window (but the last), covering C exactly."""
    assert chunk_plan(n, c, 132) == (chunks, cols)
    assert (chunks - 1) * cols < c <= chunks * cols


def test_cuda_wrappers_refuse_cpu_tensors():
    x = _emb_inputs(8, 3, 2, False, seed=2)
    res = torch.zeros(())
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_matrix_cuda(torch.ones(8, 3), _t(x["mult"]), _t(x["act"]),
                            None, res, second_price=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_lanes_cuda(torch.ones(8, 3), _t(x["mult"])[None],
                           _t(x["act"])[None], res[None], second_price=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_emb_cuda(_t(x["e"]), _t(x["r"]), _t(x["mult"]), _t(x["act"]),
                         None, res, second_price=False)
