"""Multi-slot auctions in the port against ``repro`` on the same inputs
(``repro.data.make_synthetic_env``), bit for bit: the top-k resolve (with
deliberate ties, where ``lax.top_k`` puts the lower index first), the
sequential oracle, the segment aggregate and the refinement; and the
burnout invariants of ``tests/test_multislot.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import multislot as j_ms  # noqa: E402
from repro.core.types import Segments as JSegments  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import Segments, auction  # noqa: E402
from repro_torch.core import multislot as t_ms  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS, N_CAMPAIGNS = 2048, 12


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(6), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape
    np.testing.assert_array_equal(got, want)


def _rules(slots, decay=0.5, reserve=0.0):
    j_rule = j_ms.MultiSlotRule.first_price(N_CAMPAIGNS, slots=slots,
                                            decay=decay)
    j_rule = j_ms.MultiSlotRule(
        base=j_rule.base.__class__(multipliers=j_rule.base.multipliers,
                                   reserve=jnp.float32(reserve),
                                   kind=j_rule.base.kind),
        discounts=j_rule.discounts)
    t_rule = t_ms.MultiSlotRule.first_price(N_CAMPAIGNS, slots=slots,
                                            decay=decay, device="cpu")
    t_rule = t_ms.MultiSlotRule(
        base=t_rule.base.__class__(multipliers=t_rule.base.multipliers,
                                   reserve=torch.tensor(reserve,
                                                        dtype=torch.float32),
                                   kind=t_rule.base.kind),
        discounts=t_rule.discounts)
    _same(j_rule.discounts, t_rule.discounts)
    return j_rule, t_rule


@pytest.mark.parametrize("slots", [1, 3, 5])
def test_resolve_multislot_is_repros(env, slots):
    j_rule, t_rule = _rules(slots, reserve=0.05)
    act = np.ones((N_CAMPAIGNS,), bool)
    act[3] = False
    for mask in (act, np.random.default_rng(slots).random(
            (N_EVENTS, N_CAMPAIGNS)) < 0.7):
        want = j_ms.resolve_multislot(env.values, jnp.asarray(mask), j_rule)
        got = t_ms.resolve_multislot(_t(env.values), _t(mask), t_rule)
        _same(want[0], got[0])
        _same(want[1], got[1])


def test_ties_take_the_lower_index_first():
    """Equal bids in every slot position, masked-off campaigns among them
    and rows with fewer eligible bids than slots: ``repro``'s order."""
    c = 8
    values = np.array([[0.5] * c,
                       [0.5, 0.7, 0.5, 0.7, 0.1, 0.7, 0.5, 0.2],
                       [0.0, 0.3, 0.0, 0.3, 0.0, 0.0, 0.0, 0.0],
                       [0.9, 0.9, 0.9, 0.1, 0.1, 0.1, 0.9, 0.9]],
                      np.float32)
    active = np.array([True, True, False, True, True, True, True, True])
    j_rule = j_ms.MultiSlotRule.first_price(c, slots=4)
    t_rule = t_ms.MultiSlotRule.first_price(c, slots=4, device="cpu")
    want = j_ms.resolve_multislot(jnp.asarray(values), jnp.asarray(active),
                                  j_rule)
    got = t_ms.resolve_multislot(_t(values), _t(active), t_rule)
    _same(want[0], got[0])
    _same(want[1], got[1])
    assert got[0][0].tolist() == [0, 1, 3, 4]
    assert got[0][1].tolist() == [1, 3, 5, 0]
    assert got[0][2].tolist() == [1, 3, -1, -1]


def test_sequential_replay_multislot_is_repros(env):
    j_rule, t_rule = _rules(3)
    want = j_ms.sequential_replay_multislot(env.values, env.budgets, j_rule)
    got = t_ms.sequential_replay_multislot(_t(env.values), _t(env.budgets),
                                           t_rule)
    for name in ("final_spend", "cap_times", "winners", "prices"):
        _same(getattr(want, name), getattr(got, name))
    assert int((got.cap_times <= N_EVENTS).sum()) > 0
    # irreversibility: no wins after a cap
    w, cap = got.winners.numpy(), got.cap_times.numpy()
    for c in range(N_CAMPAIGNS):
        if cap[c] <= N_EVENTS:
            assert not (w[cap[c]:] == c).any()
    assert float(got.revenue) == pytest.approx(float(got.prices.sum()))


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_aggregate_multislot_is_repros(env, slots):
    j_rule, t_rule = _rules(slots)
    oracle = j_ms.sequential_replay_multislot(env.values, env.budgets,
                                              j_rule)
    caps = np.asarray(oracle.cap_times)
    caps = np.where(np.arange(N_CAMPAIGNS) % 2 == 0, caps, caps + 37)
    want = j_ms.aggregate_multislot(
        env.values, JSegments.from_cap_times(jnp.asarray(caps), N_EVENTS),
        env.budgets, j_rule)
    got = t_ms.aggregate_multislot(
        _t(env.values), Segments.from_cap_times(_t(caps), N_EVENTS),
        _t(env.budgets), t_rule)
    for name in ("final_spend", "cap_times", "winners", "prices"):
        _same(getattr(want, name), getattr(got, name))
    flat = t_ms.auction_first_crossing(got.winners.reshape(-1),
                                       got.prices.reshape(-1),
                                       _t(env.budgets), N_CAMPAIGNS, slots,
                                       N_EVENTS)
    _same(want.cap_times, flat)
    _same(j_ms.spend_sums_multislot(want.winners, want.prices,
                                    N_CAMPAIGNS),
          t_ms.spend_sums_multislot(got.winners, got.prices, N_CAMPAIGNS))


def test_refine_segments_multislot_is_repros(env):
    j_rule, t_rule = _rules(3)
    oracle = j_ms.sequential_replay_multislot(env.values, env.budgets,
                                              j_rule)
    noisy = np.clip(np.asarray(oracle.cap_times)
                    + np.random.default_rng(0).integers(-150, 150,
                                                        N_CAMPAIGNS),
                    1, N_EVENTS + 1).astype(np.int32)
    want = j_ms.refine_segments_multislot(env.values, env.budgets, j_rule,
                                          jnp.asarray(noisy))
    got = t_ms.refine_segments_multislot(_t(env.values), _t(env.budgets),
                                         t_rule, _t(noisy))
    _same(want[0], got[0])
    assert (want[1], want[2]) == (got[1], got[2])


def test_single_slot_is_the_base_auction(env):
    _, t_rule = _rules(1)
    act = torch.ones(N_CAMPAIGNS, dtype=torch.bool)
    w1, p1 = t_ms.resolve_multislot(_t(env.values), act, t_rule)
    w2, p2 = auction.resolve(_t(env.values), act, t_rule.base)
    _same(w2, w1[:, 0])
    _same(p2, p1[:, 0])
