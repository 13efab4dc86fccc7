"""The keyed days of the port against ``repro`` on the same keys: the §7.1
synthetic day from a key (values, embeddings, a calibrated ``b_base``,
blocks crossed), the float32 orders of XLA's CPU backend it and the
Yahoo-like day repeat (the dot, the sum, ``powf``), ``prng.choice`` with
``p`` against ``jax.random.choice``, the Yahoo-like day of §7.2 at its
1,000 keywords, and the fig. 5-6 pipeline on it (both exact replays, the
day-1 warm start, SORT2AGGREGATE, the heuristics' and S2A's errors), all
bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sequential_replay as j_replay  # noqa: E402
from repro.core import sort2aggregate as j_s2a  # noqa: E402
from repro.core.metrics import spend_weighted_relative_error as j_err  # noqa: E402,E501
from repro.data import make_synthetic_env as j_synthetic  # noqa: E402
from repro.data import make_yahoo_like_env as j_yahoo  # noqa: E402
from repro.data.yahoo import as_is_prediction as j_as_is  # noqa: E402
from repro.data.yahoo import rescaled_prediction as j_rescaled  # noqa: E402
from repro_torch import floats, prng  # noqa: E402
from repro_torch.core import (sequential_replay, sort2aggregate,  # noqa: E402
                              spend_weighted_relative_error)
from repro_torch.data import make_synthetic_env, make_yahoo_like_env  # noqa: E402,E501
from repro_torch.data.yahoo import (as_is_prediction,  # noqa: E402
                                    rescaled_prediction)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(want, got, what=""):
    want, got = np.asarray(want), got.cpu().numpy()
    assert want.shape == got.shape and want.dtype == got.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# the keyed synthetic day
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,d,block,b_base", [
    (5000, 16, 10, 2048, None),      # four-chain dot, three blocks
    (3000, 100, 10, 1024, None),     # the paper's C and d: one chain
    (2048, 20, 10, 1000, 2.0),       # two chains, a 48-row last block
    (2048, 37, 6, 1000, None),       # two chains with a tail
])
def test_keyed_synthetic_day_is_repros(n, c, d, block, b_base):
    """``make_synthetic_env(prng.PRNGKey(k))`` is ``repro``'s day for
    ``jax.random.PRNGKey(k)``: values, event and campaign embeddings, and
    the budgets of its calibrated (or given) ``b_base``."""
    want = j_synthetic(jax.random.PRNGKey(11), n_events=n, n_campaigns=c,
                       emb_dim=d, block=block, b_base=b_base)
    got = make_synthetic_env(prng.PRNGKey(11), n_events=n, n_campaigns=c,
                             emb_dim=d, block=block, b_base=b_base,
                             device="cpu")
    for name in ("values", "event_emb", "campaign_emb", "budgets"):
        _same(getattr(want, name), getattr(got, name), name)


@pytest.mark.parametrize("c,d", [
    (513, 10), (600, 10), (100, 20), (100, 32), (1, 8),   # differed before
    (100, 10),                                           # bitwise before
    (2000, 12), (700, 64),
])
def test_keyed_day_is_repros_wherever_the_dot_order_is_measured(c, d):
    """The (C, d) whose values differed from ``repro``'s in 17-31% of cells
    while :data:`floats.DOT_CHAINS` covered C <= 512, d <= 16 are bitwise
    now, as is (100, 10)."""
    want = j_synthetic(jax.random.PRNGKey(3), n_events=300, n_campaigns=c,
                       emb_dim=d, block=256, b_base=1.0)
    got = make_synthetic_env(prng.PRNGKey(3), n_events=300, n_campaigns=c,
                             emb_dim=d, block=256, b_base=1.0, device="cpu")
    for name in ("values", "event_emb", "campaign_emb"):
        _same(getattr(want, name), getattr(got, name), name)


@pytest.mark.parametrize("c,d", [(1, 10), (100, 65), (20_000, 10)])
def test_keyed_day_refuses_an_unmeasured_dot_order(c, d):
    """Where XLA CPU's chain count is not measured (no count matched at
    C = 1 for this d; d past 64; C past 16,384) the keyed day raises
    rather than give other bits than ``repro``'s."""
    with pytest.raises(ValueError, match="not measured"):
        make_synthetic_env(prng.PRNGKey(3), n_events=64, n_campaigns=c,
                           emb_dim=d, b_base=1.0, device="cpu")


def test_seed_path_still_builds_a_day():
    """An int keeps the port's own generator: a valid day, not
    ``repro``'s bits."""
    env = make_synthetic_env(3, n_events=1024, n_campaigns=8, emb_dim=4,
                             b_base=1.0, device="cpu")
    again = make_synthetic_env(3, n_events=1024, n_campaigns=8, emb_dim=4,
                               b_base=1.0, device="cpu")
    assert torch.equal(env.values, again.values)
    assert env.values.shape == (1024, 8)
    assert bool(((env.values > 0) & (env.values <= 1)).all())


@pytest.mark.parametrize("m,n,k", [
    (64, 16, 10), (64, 20, 10), (64, 100, 10), (64, 64, 10), (2, 200, 10),
    (1, 16, 10), (64, 30, 7), (64, 24, 8), (64, 80, 5), (64, 512, 16),
    (64, 3, 3), (64, 40, 13),
    (16, 1, 8), (64, 2000, 10), (64, 1500, 64), (64, 3000, 15),
    (4096, 100, 33),
])
def test_xla_dot_is_xlas(m, n, k):
    """:func:`floats.xla_dot` is XLA CPU's ``a @ b.T`` bit for bit at
    shapes of each kernel of :data:`floats.DOT_CHAINS` (one, two, four and
    eight chains, with and without a tail; one row; N past the 1,024 of
    the table's every-N measurement; 4,096 rows)."""
    rng = np.random.default_rng(m * 1000 + n * 10 + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((n, k)).astype(np.float32)
    want = jax.jit(lambda x, y: x @ y.T)(a, b)
    _same(want, floats.xla_dot(torch.from_numpy(a), torch.from_numpy(b)))


@pytest.mark.parametrize("n", [1, 20, 32, 33, 1000, 5000])
def test_xla_sum_and_powf_are_xlas(n):
    """:func:`floats.xla_sum` is ``jnp.sum`` of a float32 vector and
    :func:`floats.powf` is ``x ** y``, bit for bit."""
    x = np.random.default_rng(n).random(n).astype(np.float32)
    assert float(floats.xla_sum(torch.from_numpy(x))) == \
        float(jnp.asarray(x).sum())
    ranks = np.arange(1, n + 1, dtype=np.float32)
    for a in (1.1, 0.5, 2.0):
        _same(jnp.asarray(ranks) ** (-a),
              floats.powf(torch.from_numpy(ranks), -a), f"pow {a}")


# ---------------------------------------------------------------------------
# choice with p
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,shape", [
    (0, 1000, (3000,)), (1, 1000, (5,)), (2, 7, (2, 3)), (3, 17, (100,)),
    (4, 1, (4,)),
])
def test_choice_with_p_is_jaxs(seed, n, shape):
    """``prng.choice(key, n, shape, replace=True, p=p)`` is
    ``jax.random.choice(key, n, shape, p=p)``: the cumsum in XLA's order,
    the scaled uniforms and ``searchsorted``'s bisection."""
    p = np.random.default_rng(seed).random(n).astype(np.float32) ** 3
    p /= p.sum()
    want = jax.random.choice(jax.random.PRNGKey(seed), n, shape,
                             p=jnp.asarray(p))
    got = prng.choice(prng.PRNGKey(seed), n, shape, replace=True,
                      p=torch.from_numpy(p))
    _same(want, got)


def test_choice_forms_not_ported_raise():
    p = torch.full((4,), 0.25)
    with pytest.raises(NotImplementedError, match="item 10"):
        prng.choice(prng.PRNGKey(0), 4, 2, replace=False, p=p)
    with pytest.raises(NotImplementedError, match="item 10"):
        prng.choice(prng.PRNGKey(0), 4, 2, replace=True)
    with pytest.raises(ValueError, match="p must be None"):
        prng.choice(prng.PRNGKey(0), 5, 2, replace=True, p=p)


# ---------------------------------------------------------------------------
# the Yahoo-like day
# ---------------------------------------------------------------------------

YAHOO = dict(n_keywords=1000, n_campaigns=40, n_day1=4096, n_day2=6144,
             budget=12.0)


@pytest.fixture(scope="module")
def yahoo():
    return (j_yahoo(jax.random.PRNGKey(0), **YAHOO),
            make_yahoo_like_env(prng.PRNGKey(0), device="cpu", **YAHOO))


def test_yahoo_like_day_is_repros(yahoo):
    """The bid table, both days' keywords, the budgets and both days'
    valuations at 1,000 keywords (the real length of the popularity's
    ``pow``, sum and cumsum)."""
    want, got = yahoo
    for name in ("bid_table", "day1_keywords", "day2_keywords", "budgets"):
        _same(getattr(want, name), getattr(got, name), name)
    for day in (1, 2):
        _same(want.values(day), got.values(day), f"values({day})")
    assert got.n_campaigns == want.n_campaigns
    assert got.rule.kind == want.rule.kind


def test_fig56_pipeline_is_repros(yahoo):
    """fig. 5-6 on the day pair: both exact replays, the heuristics, the
    day-1 warm start rescaled to day 2's volume, SORT2AGGREGATE from it
    (12 refine passes) and the spend-weighted errors, all ``repro``'s."""
    want, got = yahoo
    n1, n2 = YAHOO["n_day1"], YAHOO["n_day2"]
    j1 = j_replay(want.values(1), want.budgets, want.rule)
    j2 = j_replay(want.values(2), want.budgets, want.rule)
    d1 = sequential_replay(got.values(1), got.budgets, got.rule)
    d2 = sequential_replay(got.values(2), got.budgets, got.rule)
    for name in ("final_spend", "cap_times"):
        _same(getattr(j1, name), getattr(d1, name), f"day 1 {name}")
        _same(getattr(j2, name), getattr(d2, name), f"day 2 {name}")
    capped = int((d2.cap_times <= n2).sum())
    assert 0 < capped < YAHOO["n_campaigns"]
    caps1 = np.asarray(j1.cap_times, np.int64)
    j_warm = np.where(caps1 <= n1, np.minimum((caps1 * n2) // n1, n2),
                      n2 + 1).astype(np.int32)
    warm = torch.where(d1.cap_times.long() <= n1,
                       torch.clamp((d1.cap_times.long() * n2) // n1, max=n2),
                       n2 + 1).to(torch.int32)
    _same(j_warm, warm, "warm start")
    js = j_s2a(want.values(2), want.budgets, want.rule,
               cap_times_init=j_warm, refine_iters=12)
    s2a = sort2aggregate(got.values(2), got.budgets, got.rule,
                         cap_times_init=warm, refine_iters=12)
    _same(js.result.final_spend, s2a.result.final_spend, "s2a spend")
    _same(js.result.cap_times, s2a.result.cap_times, "s2a caps")
    assert s2a.refine_iters_used == js.refine_iters_used
    for j_pred, pred in (
            (j_as_is(j1.final_spend), as_is_prediction(d1.final_spend)),
            (j_rescaled(j1.final_spend, n1, n2, want.budgets),
             rescaled_prediction(d1.final_spend, n1, n2, got.budgets)),
            (js.result.final_spend, s2a.result.final_spend)):
        _same(j_pred, pred)
        assert float(spend_weighted_relative_error(pred, d2.final_spend)) \
            == float(j_err(j_pred, j2.final_spend))
