"""The exact sequential oracle: the port's batched capped-scan plain
version, ``sequential_replay`` and ``sweep_sequential`` against ``repro``'s
``capped_scan_ref``, its Pallas ``capped_scan`` (interpret mode) and its
``sequential_replay`` / ``sweep_sequential``, bit for bit.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against this plain version there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import sequential_replay as j_replay  # noqa: E402
from repro.core import sweep_sequential as j_sweep_sequential  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.kernels.capped_scan import capped_scan as j_capped_scan  # noqa: E402
from repro.kernels.capped_scan import capped_scan_ref as j_scan_ref  # noqa: E402
from repro_torch.core import (AuctionRule, CounterfactualEngine,  # noqa: E402
                              sequential_replay, sweep_sequential)
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.kernels.capped_scan import capped_scan as cuda_cs  # noqa: E402
from repro_torch.kernels.capped_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.capped_scan.ref import capped_scan_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OUTPUTS = ("winners", "prices", "final_spend", "cap_times")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _lanes(n, c, s, seed):
    """Valuations, (S, C) budgets and multipliers, (S,) reserves: lane 0 is
    the plain design; the others carry a reserve, a zero budget (caps at
    event 1 without a sale) and a zero multiplier (never bids)."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 1.0, (n, c)).astype(np.float32)
    budgets = rng.uniform(0.5, 0.02 * n, (s, c)).astype(np.float32)
    mult = rng.uniform(0.5, 1.5, (s, c)).astype(np.float32)
    mult[0] = 1.0
    budgets[1:, 2] = 0.0
    mult[1:, 3] = 0.0
    reserves = np.linspace(0.0, 0.4, s).astype(np.float32)
    return values, budgets, mult, reserves


def _assert_equal(want, got, what):
    for name, a, b in zip(OUTPUTS, want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, f"{what}: {name}"
        np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{what}: {name}")


@pytest.mark.parametrize("n,c,s", [(1024, 24, 3), (700, 37, 4)])
def test_capped_scan_ref_is_the_reference_oracle(n, c, s):
    """First price, lane by lane, against ``repro``'s ``capped_scan_ref``
    (the Pallas kernel's oracle)."""
    values, budgets, mult, reserves = _lanes(n, c, s, seed=n)
    out = capped_scan_ref(_t(values), _t(budgets), _t(mult), _t(reserves))
    for k in range(s):
        want = j_scan_ref(jnp.asarray(values), jnp.asarray(budgets[k]),
                          jnp.asarray(mult[k]), jnp.float32(reserves[k]))
        _assert_equal(want, [x[k] for x in out], f"lane {k}")


def test_capped_scan_matches_the_pallas_kernel_in_interpret_mode():
    """``repro``'s Pallas ``capped_scan`` (interpret mode, its padding
    included) against the port's ``ops.capped_scan`` on one lane."""
    values, budgets, mult, reserves = _lanes(1500, 20, 2, seed=3)
    want = j_capped_scan(jnp.asarray(values), jnp.asarray(budgets[1]),
                         jnp.asarray(mult[1]), jnp.float32(reserves[1]),
                         block_t=512, interpret=True)
    got = scan_ops.capped_scan(_t(values), _t(budgets[1]), _t(mult[1]),
                               float(reserves[1]))
    _assert_equal(want, got, "interpret")
    assert int(got[3][2]) == 1                     # zero budget: cap at 1


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_capped_scan_matches_the_reference_replay(kind):
    """Both pricing rules: each lane of the batched plain version against
    ``repro``'s ``sequential_replay`` of that lane's design."""
    values, budgets, mult, reserves = _lanes(900, 16, 3, seed=11)
    out = scan_ops.capped_scan(_t(values), _t(budgets), _t(mult),
                               _t(reserves),
                               second_price=kind == "second_price")
    for k in range(3):
        rule = JRule(multipliers=jnp.asarray(mult[k]),
                     reserve=jnp.float32(reserves[k]), kind=kind)
        ref = j_replay(jnp.asarray(values), jnp.asarray(budgets[k]), rule)
        _assert_equal((ref.winners, ref.prices, ref.final_spend,
                       ref.cap_times), [x[k] for x in out], f"lane {k}")


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(2), n_events=2048,
                              n_campaigns=12, emb_dim=6)


@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_sweep_sequential_bitwise_the_reference(env, kind):
    """The port's sweep oracle (one batched replay) against ``repro``'s
    vmapped one, events recorded."""
    base = JRule(multipliers=jnp.ones(12), reserve=jnp.float32(0.0),
                 kind=kind)
    grid = JGrid.product(base, env.budgets, bid_scales=[1.0, 1.3],
                         reserves=[0.0, 0.05], budget_scales=[1.0, 0.3])
    want = j_sweep_sequential(env.values, grid.budgets, grid.rules,
                              record_events=True)
    values, t_grid = from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        kind, device="cpu")
    cuda_cs.reset_launches()
    got = sweep_sequential(values, t_grid.budgets, t_grid.rules,
                           record_events=True)
    assert cuda_cs.LAUNCHES["capped_scan"] == 0    # the CPU never launches
    _assert_equal((want.winners, want.prices, want.final_spend,
                   want.cap_times),
                  (got.winners, got.prices, got.final_spend, got.cap_times),
                  kind)
    engine = CounterfactualEngine(values, t_grid.budgets[0], device="cpu")
    swept = engine.sweep(t_grid, method="sequential").results
    assert torch.equal(swept.final_spend, got.final_spend)
    assert swept.winners is None


def test_sequential_replay_lane_is_the_batched_lane(env):
    """The CPU oracle loop (one design) and the batched plain version (all
    designs) give the same bits for the same design."""
    values = _t(env.values)
    budgets = _t(env.budgets) * 0.4
    rule = AuctionRule(multipliers=torch.full((12,), 1.1),
                       reserve=torch.tensor(0.02), kind="second_price")
    solo = sequential_replay(values, budgets, rule)
    batched = scan_ops.capped_scan(values, budgets[None],
                                   rule.multipliers[None], rule.reserve,
                                   second_price=True)
    _assert_equal((solo.winners, solo.prices, solo.final_spend,
                   solo.cap_times), [x[0] for x in batched], "lane")


def test_capped_scan_defaults_and_unknown_kind():
    values, budgets, _, _ = _lanes(300, 8, 1, seed=4)
    plain = scan_ops.capped_scan(_t(values), _t(budgets[0]))
    ones = scan_ops.capped_scan(_t(values), _t(budgets[0]),
                                torch.ones(8), 0.0)
    for a, b in zip(plain, ones):
        assert torch.equal(a, b)
    assert plain[0].shape == (300,) and plain[3].shape == (8,)
    rules = AuctionRule(multipliers=torch.ones(1, 8),
                        reserve=torch.zeros(1), kind="vickrey")
    with pytest.raises(ValueError, match="unknown auction kind"):
        sweep_sequential(_t(values), _t(budgets), rules)


def test_capped_scan_wrapper_refuses_cpu_tensors():
    values, budgets, mult, reserves = _lanes(64, 4, 2, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_cs.capped_scan_cuda(_t(values), _t(budgets), _t(mult),
                                 _t(reserves), second_price=False)
