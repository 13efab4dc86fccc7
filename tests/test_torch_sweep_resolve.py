"""The scenario-batched resolve: the port's ``ops.sweep_resolve`` (its
plain version on CPU tensors) against ``repro``'s ``sweep_resolve_ref`` and
its Pallas ``sweep_resolve`` (interpret mode), and the ``"sweep_resolve"``
back-end of the executor against ``repro``'s ``execute_sweep`` with
``resolve="pallas"`` and ``"jnp"``.

Winners and prices are bit for bit. Spend sums are held at rtol 1e-5, atol
1e-6·max|sums|: the port folds event-ordered block partials, ``repro``'s
oracle and kernel sum each lane through a one-hot reduction in another
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import sweep_state_machine as j_ssm  # noqa: E402
from repro.core.executor import SweepPlan as JPlan  # noqa: E402
from repro.core.executor import execute_sweep as j_execute  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro.kernels.auction_resolve import ops as j_ops  # noqa: E402
from repro.kernels.auction_resolve import ref as j_ref  # noqa: E402
from repro_torch.core import (CounterfactualEngine, SweepPlan,  # noqa: E402
                              execute_sweep, sweep_state_machine)
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.kernels.auction_resolve import ops as t_ops  # noqa: E402
from repro_torch.kernels.auction_resolve import ref as t_ref  # noqa: E402
from repro_torch.kernels.auction_resolve import \
    sweep_resolve as cuda_sr  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OUTPUTS = ("final_spend", "cap_times", "retired", "boundaries", "num_rounds",
           "n_hat")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _inputs(s, n, c, per_event, seed):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0.0, 1.0, (n, c)).astype(np.float32)
    mult = rng.uniform(0.5, 1.5, (s, c)).astype(np.float32)
    shape = (s, n, c) if per_event else (s, c)
    act = rng.uniform(size=shape) < 0.75
    res = rng.uniform(0.0, 0.3, s).astype(np.float32)
    return values, mult, act, res


def _close_sums(want, got):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


CASES = [
    (4, 512, 16, False),
    (3, 1000, 37, False),        # ragged N and C
    (5, 700, 129, True),         # per-event mask, C past one staged segment
    (2, 300, 7, True),
]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("s,n,c,per_event", CASES)
def test_sweep_resolve_is_the_reference_oracle(s, n, c, per_event, sp):
    values, mult, act, res = _inputs(s, n, c, per_event, seed=n + c)
    want = j_ref.sweep_resolve_ref(jnp.asarray(values), jnp.asarray(mult),
                                   jnp.asarray(act), jnp.asarray(res),
                                   second_price=sp)
    got = t_ops.sweep_resolve(_t(values), _t(mult), _t(act), _t(res),
                              second_price=sp)
    for name, a, b in zip(("winners", "prices"), want[:2], got[:2]):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    _close_sums(want[2], got[2])


@pytest.mark.parametrize("s,n,c,per_event", CASES[1:3])
def test_sweep_resolve_matches_the_pallas_kernel_in_interpret_mode(
        s, n, c, per_event):
    values, mult, act, res = _inputs(s, n, c, per_event, seed=c)
    want = j_ops.sweep_resolve(jnp.asarray(values), jnp.asarray(mult),
                               jnp.asarray(act), jnp.asarray(res),
                               second_price=True, block_t=256,
                               interpret=True)
    got = t_ops.sweep_resolve(_t(values), _t(mult), _t(act), _t(res),
                              second_price=True)
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    _close_sums(want[2], got[2])


def test_sweep_resolve_sums_are_the_folded_event_ordered_partials():
    """The plain version's sums are exactly what the CUDA kernel computes:
    event-ordered canonical partials folded in order."""
    from repro_torch.core import segments
    values, mult, act, res = _inputs(3, 1000, 21, False, seed=5)
    winners, prices, sums = t_ops.sweep_resolve(_t(values), _t(mult),
                                                _t(act), _t(res))
    block = segments.reduce_block_size(1000)
    for k in range(3):
        parts = segments.partial_spend_sums(winners[k], prices[k], 21,
                                            block_size=block)
        assert torch.equal(sums[k], segments.fold_blocks(parts))
    resolved = t_ref.sweep_resolve_ref(_t(values), _t(mult), _t(act),
                                       _t(res))
    for a, b in zip(resolved, (winners, prices, sums)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(1), n_events=4096,
                              n_campaigns=16, emb_dim=8)


def _grid(kind, budgets):
    base = JRule.first_price(16) if kind == "first_price" \
        else JRule.second_price(16)
    return JGrid.product(base, budgets, bid_scales=[1.0, 1.2],
                         reserves=[0.0, 0.05], budget_scales=[1.0, 0.5])


def _port(env, grid):
    return from_reference(
        np.asarray(env.values), np.asarray(grid.budgets),
        np.asarray(grid.rules.multipliers), np.asarray(grid.rules.reserve),
        grid.rules.kind, grid.labels, device="cpu")


@pytest.mark.parametrize("j_resolve", ["pallas", "jnp"])
@pytest.mark.parametrize("kind", ["first_price", "second_price"])
def test_sweep_resolve_backend_bitwise_the_reference(env, kind, j_resolve):
    """``SweepPlan(resolve="sweep_resolve")`` against ``repro``'s
    ``execute_sweep`` with its Pallas resolve (interpret mode) and its jnp
    resolve: all six outputs equal, dtypes included."""
    grid = _grid(kind, env.budgets)
    want = j_execute(env.values, grid.budgets, grid.rules,
                     JPlan(placement="batched", resolve=j_resolve,
                           interpret=True if j_resolve == "pallas" else None))
    values, t_grid = _port(env, grid)
    got = execute_sweep(values, t_grid.budgets, t_grid.rules,
                        SweepPlan(resolve="sweep_resolve"))
    for name, a, b in zip(OUTPUTS, want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_sweep_state_machine_defaults_to_sweep_resolve(env):
    """``repro``'s default back-end here is its Pallas resolve; the port's
    is its counterpart. The CPU never launches a kernel."""
    grid = _grid("first_price", env.budgets)
    want = j_ssm(env.values, grid.budgets, grid.rules, resolve="jnp")
    values, t_grid = _port(env, grid)
    cuda_sr.reset_launches()
    got = sweep_state_machine(values, t_grid.budgets, t_grid.rules)
    assert cuda_sr.LAUNCHES["sweep_resolve"] == 0
    for name, a, b in zip(OUTPUTS, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    engine = CounterfactualEngine(values, t_grid.budgets[0], device="cpu")
    swept = engine.sweep(t_grid, resolve="sweep_resolve").results
    assert torch.equal(swept.final_spend, got[0])
    assert torch.equal(swept.cap_times, got[1])


def test_sweep_resolve_wrapper_refuses_cpu_tensors():
    values, mult, act, res = _inputs(2, 64, 4, False, seed=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_sr.sweep_resolve_cuda(_t(values), _t(mult), _t(act), _t(res),
                                   second_price=False, reduce_blocks=32)
