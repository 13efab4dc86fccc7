"""The port's auction rule, canonical reductions and oracle against
``repro``'s: the same numpy inputs through both, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import auction as j_auction  # noqa: E402
from repro.core import segments as j_seg  # noqa: E402
from repro.core.sequential import capped_sum as j_capped_sum  # noqa: E402
from repro.core.sequential import sequential_replay as j_replay  # noqa: E402
from repro.core.types import AuctionRule as JRule  # noqa: E402
from repro_torch.core import auction as t_auction  # noqa: E402
from repro_torch.core import segments as t_seg  # noqa: E402
from repro_torch.core.sequential import capped_sum, sequential_replay  # noqa: E402
from repro_torch.core.types import AuctionRule  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rules(kind, mult, reserve):
    j = JRule(multipliers=jnp.asarray(mult), reserve=jnp.float32(reserve),
              kind=kind)
    t = AuctionRule(multipliers=torch.from_numpy(mult.copy()),
                    reserve=torch.tensor(reserve, dtype=torch.float32),
                    kind=kind)
    return j, t


def _inputs(seed, t=512, c=12, ties=False):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 1.0, (t, c)).astype(np.float32)
    if ties:   # quantised values: many equal top and second bids
        values = np.round(values * 4) / 4
    mult = rng.uniform(0.7, 1.3, c).astype(np.float32)
    if ties:
        mult[:] = 1.0
    return values, mult


def _assert_same(j_out, t_out):
    for a, b in zip(j_out, t_out):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("reserve", [0.0, 0.3])
@pytest.mark.parametrize("mask", ["shared", "per_event"])
def test_resolve_bit_identical(kind, ties, reserve, mask):
    values, mult = _inputs(7, ties=ties)
    rng = np.random.default_rng(11)
    shape = (values.shape[1],) if mask == "shared" else values.shape
    active = rng.uniform(size=shape) < 0.7
    j_rule, t_rule = _rules(kind, mult, reserve)
    j_out = j_auction.resolve(jnp.asarray(values), jnp.asarray(active),
                              j_rule)
    t_out = t_auction.resolve(torch.from_numpy(values),
                              torch.from_numpy(active), t_rule)
    _assert_same(j_out, t_out)


def test_resolve_row_and_spend_helpers_bit_identical():
    values, mult = _inputs(3, t=256, c=9)
    active = np.random.default_rng(4).uniform(size=9) < 0.8
    j_rule, t_rule = _rules("second_price", mult, 0.1)
    jw, jp = j_auction.resolve(jnp.asarray(values), jnp.asarray(active),
                               j_rule)
    tw, tp = t_auction.resolve(torch.from_numpy(values),
                               torch.from_numpy(active), t_rule)
    _assert_same(j_auction.resolve_row(jnp.asarray(values[5]),
                                       jnp.asarray(active), j_rule),
                 t_auction.resolve_row(torch.from_numpy(values[5]),
                                       torch.from_numpy(active), t_rule))
    _assert_same([j_auction.spend_sums(jw, jp, 9),
                  j_auction.spend_matrix(jw, jp, 9)],
                 [t_auction.spend_sums(tw, tp, 9),
                  t_auction.spend_matrix(tw, tp, 9)])


@pytest.mark.parametrize("offset,n_global", [(0, 512), (256, 1024),
                                             (700, 2000)])
def test_partial_spend_sums_with_offset_bit_identical(offset, n_global):
    values, mult = _inputs(5, t=300, c=10)
    j_rule, t_rule = _rules("first_price", mult, 0.05)
    act = np.ones(10, bool)
    jw, jp = j_auction.resolve(jnp.asarray(values), jnp.asarray(act), j_rule)
    tw, tp = t_auction.resolve(torch.from_numpy(values),
                               torch.from_numpy(act), t_rule)
    weight = (np.arange(300) % 3 != 0).astype(np.float32)
    block = t_seg.reduce_block_size(n_global)
    assert block == j_seg.reduce_block_size(n_global)
    j_parts = j_seg.partial_spend_sums(jw, jp, 10, jnp.asarray(weight),
                                       block_size=block,
                                       index_offset=offset)
    t_parts = t_seg.partial_spend_sums(tw, tp, 10, torch.from_numpy(weight),
                                       block_size=block,
                                       index_offset=offset)
    _assert_same([j_parts], [t_parts])
    # the in-order fold is XLA's sum over the block axis
    _assert_same([j_parts.sum(axis=0)], [t_seg.fold_blocks(t_parts)])


@pytest.mark.parametrize("lo,hi", [(0, 4096), (1000, 3000), (4000, 4096)])
def test_rate_and_block_from_events_bit_identical(lo, hi):
    values, mult = _inputs(9, t=4096, c=16)
    j_rule, t_rule = _rules("second_price", mult, 0.02)
    act = np.random.default_rng(1).uniform(size=16) < 0.75
    jw, jp = j_auction.resolve(jnp.asarray(values), jnp.asarray(act), j_rule)
    tw, tp = t_auction.resolve(torch.from_numpy(values),
                               torch.from_numpy(act), t_rule)
    _assert_same(
        [j_seg.rate_from_events(jw, jp, 16, jnp.int32(lo)),
         j_seg.block_from_events(jw, jp, 16, jnp.int32(lo), jnp.int32(hi))],
        [t_seg.rate_from_events(tw, tp, 16, torch.tensor(lo)),
         t_seg.block_from_events(tw, tp, 16, torch.tensor(lo),
                                 torch.tensor(hi))])


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_sequential_replay_equal(kind):
    values, mult = _inputs(21, t=768, c=8)
    budgets = np.linspace(3.0, 30.0, 8).astype(np.float32)
    j_rule, t_rule = _rules(kind, mult, 0.05)
    j_res = j_replay(jnp.asarray(values), jnp.asarray(budgets), j_rule)
    t_res = sequential_replay(torch.from_numpy(values),
                              torch.from_numpy(budgets), t_rule)
    _assert_same([j_res.final_spend, j_res.cap_times, j_res.winners,
                  j_res.prices],
                 [t_res.final_spend, t_res.cap_times, t_res.winners,
                  t_res.prices])
    assert int(t_res.num_capped(768)) > 0


def test_capped_sum():
    xs = np.random.default_rng(2).uniform(size=100).astype(np.float32)
    for budget in (10.0, 1e6):
        np.testing.assert_array_equal(
            np.asarray(j_capped_sum(jnp.asarray(xs), budget)),
            capped_sum(torch.from_numpy(xs), budget).numpy())
