"""Algorithm 4's chain as ``csrc/vi.cu`` computes it, on the CPU:
``ref.vi_chain_ref`` consumes the kernel's own inputs (the padded sampled
rows, the uniforms, each step's size, each batch's live count, the
per-event budgets) and repeats its split (interleaved column slices a row,
merged in the kernel's shuffle order; the sums added row by row). It is held
bit for bit against ``core.vi``'s loop on the CPU (the plain version) and
against ``repro``'s ``estimate_pi`` and ``estimate_pi_sweep``, for both
rules and both couplings, batches of 1, of a size that does not divide the
sample and of more rows than the kernel has threads, a given ``pi0`` and
``track_every``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import AuctionRule as JRule  # noqa: E402
from repro.core import ScenarioGrid as JGrid  # noqa: E402
from repro.core import vi as j_vi  # noqa: E402
from repro.data import make_synthetic_env  # noqa: E402
from repro_torch.core import AuctionRule, vi  # noqa: E402
from repro_torch.interop import from_reference, key_from_reference  # noqa: E402
from repro_torch.kernels.auction_resolve import ref  # noqa: E402
from repro_torch.kernels.auction_resolve.vi import vi_cuda  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_EVENTS, N_CAMPAIGNS = 4096, 16
KINDS = ("first_price", "second_price")


@pytest.fixture(scope="module")
def env():
    return make_synthetic_env(jax.random.PRNGKey(1), n_events=N_EVENTS,
                              n_campaigns=N_CAMPAIGNS, emb_dim=8)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _design(kind):
    m = jnp.linspace(0.9, 1.2, N_CAMPAIGNS, dtype=jnp.float32)
    return JRule(multipliers=m, reserve=jnp.float32(0.02), kind=kind)


def _kernel_inputs(values, budgets, key, *, sample_size, num_iters,
                   batch_size, coupling, eta_decay):
    """The kernel's inputs, built as ``core.vi`` builds them."""
    draws = vi._draws(key, N_EVENTS, N_CAMPAIGNS, sample_size=sample_size,
                      num_iters=num_iters, batch_size=batch_size,
                      coupling=coupling, device="cpu")
    chain = vi._chain(values, budgets, draws, sample_size=sample_size,
                      batch_size=batch_size, eta=0.5, eta_decay=eta_decay)
    return draws, chain


# (batch_size, coupling, sample_size, num_iters, pi0, track_every): 64 rows
# not dividing the sample (tpr 4); one row (tpr 32, slices past the 4
# quads of 16 columns); 20 rows (tpr 8); 3 rows with a pi0 (tpr 32); 600
# rows, more than the kernel's 256 resolving threads (tpr 1, three passes
# of rows)
CASES = {
    "B64_shared": (64, "shared", 200, 30, None, 3),
    "B64_independent": (64, "independent", 200, 30, None, 0),
    "B1_shared": (1, "shared", 40, 3, None, 7),
    "B20_independent": (20, "independent", 100, 5, None, 0),
    "B3_pi0": (3, "shared", 50, 4, 0.7, 2),
    "B600_independent": (600, "independent", 1500, 2, None, 0),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_vi_chain_ref_is_the_loop_and_the_reference(env, case, kind):
    batch_size, coupling, sample_size, num_iters, p0, track = CASES[case]
    assert ref.vi_threads_per_row(batch_size) == {
        64: 4, 1: 32, 20: 8, 3: 32, 600: 1}[batch_size]
    rule = _design(kind)
    key = jax.random.PRNGKey(3)
    kw = dict(sample_size=sample_size, num_iters=num_iters,
              batch_size=batch_size, coupling=coupling, eta_decay=0.05)
    pi0 = None if p0 is None else jnp.full((N_CAMPAIGNS,), p0, jnp.float32)
    want = j_vi.estimate_pi(env.values, env.budgets, rule, key, pi0=pi0,
                            track_every=track, **kw)
    values, budgets = _t(env.values), _t(env.budgets)
    t_key = key_from_reference(np.asarray(key))
    loop = vi.estimate_pi(values, budgets, AuctionRule(
        multipliers=_t(rule.multipliers), reserve=_t(rule.reserve),
        kind=kind), t_key, pi0=None if pi0 is None else _t(pi0),
        track_every=track, **kw)
    draws, chain = _kernel_inputs(values, budgets, t_key, **kw)
    pi_start = torch.ones((1, N_CAMPAIGNS)) if pi0 is None \
        else _t(pi0)[None]
    got, hist = ref.vi_chain_ref(
        chain.sampled, draws.u, chain.step, chain.denom, chain.btilde[None],
        _t(rule.multipliers)[None], _t(rule.reserve).reshape(1), pi_start,
        sample_size=sample_size, second_price=kind == "second_price",
        track_every=track)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.pi))
    assert torch.equal(got[0], loop.pi)
    if track:
        np.testing.assert_array_equal(hist[0].numpy(),
                                      np.asarray(want.history))
        assert torch.equal(hist[0], loop.history)
    else:
        assert hist is None and loop.history is None
    # the estimate moved off its start: the chain did something
    assert not torch.equal(got[0], pi_start[0])


# the split's edges, each at its own C: (batch_size, coupling, sample_size,
# num_iters, C): fewer steps than the ring's four stages; a ring of four
# slots over three batches an epoch (the slots wrap across epochs); one row
# at C=37 (columns, not quads); 13 rows (tpr 16, two rows a warp: 13 is
# no multiple of them); 100 rows (tpr 2, sixteen rows a warp) at C=36
# (nine quads), W = C; C=1, both couplings
SPLIT_EDGES = {
    "total_below_stages": (64, "shared", 150, 1, 16),
    "ring_wraps_epochs": (64, "independent", 150, 7, 16),
    "B1_C37": (1, "shared", 30, 2, 37),
    "B13_C37": (13, "shared", 100, 3, 37),
    "B100_C36_independent": (100, "independent", 300, 3, 36),
    "C1_independent": (20, "independent", 120, 3, 1),
    "C1_shared": (64, "shared", 200, 2, 1),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", sorted(SPLIT_EDGES))
def test_vi_chain_ref_split_edges(case, kind):
    """The kernel's split at its edges (ring, rows a warp, quads or
    columns, W = C, C=1): ``vi_chain_ref`` is ``repro``'s ``estimate_pi``
    and the port's CPU loop, bit for bit."""
    batch_size, coupling, sample_size, num_iters, c = SPLIT_EDGES[case]
    n = 1024
    env_c = make_synthetic_env(jax.random.PRNGKey(2), n_events=n,
                               n_campaigns=c, emb_dim=4)
    rule = JRule(multipliers=jnp.linspace(0.9, 1.2, c, dtype=jnp.float32),
                 reserve=jnp.float32(0.02), kind=kind)
    key = jax.random.PRNGKey(5)
    kw = dict(sample_size=sample_size, num_iters=num_iters,
              batch_size=batch_size, coupling=coupling, eta_decay=0.05)
    # repro's second price takes top_k(2) of the columns: C=1 has one, so
    # there the port's CPU loop is the witness alone
    want = None if c == 1 and kind == "second_price" else \
        j_vi.estimate_pi(env_c.values, env_c.budgets, rule, key, **kw)
    values, budgets = _t(env_c.values), _t(env_c.budgets)
    t_key = key_from_reference(np.asarray(key))
    loop = vi.estimate_pi(values, budgets, AuctionRule(
        multipliers=_t(rule.multipliers), reserve=_t(rule.reserve),
        kind=kind), t_key, **kw)
    draws = vi._draws(t_key, n, c, sample_size=sample_size,
                      num_iters=num_iters, batch_size=batch_size,
                      coupling=coupling, device="cpu")
    chain = vi._chain(values, budgets, draws, sample_size=sample_size,
                      batch_size=batch_size, eta=0.5, eta_decay=0.05)
    got, _ = ref.vi_chain_ref(
        chain.sampled, draws.u, chain.step, chain.denom, chain.btilde[None],
        _t(rule.multipliers)[None], _t(rule.reserve).reshape(1),
        torch.ones((1, c)), sample_size=sample_size,
        second_price=kind == "second_price")
    if want is not None:
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want.pi))
    assert torch.equal(got[0], loop.pi)
    assert bool(((got >= 0) & (got <= 1)).all())


@pytest.mark.parametrize("c,tpr", [(100, 4), (16, 32), (37, 8), (1, 2),
                                   (36, 2), (36, 16)])
def test_vi_slices_cover_each_column_once(c, tpr):
    """Every column in exactly one slice, ascending within it: quads when
    C is a multiple of 4, columns otherwise."""
    slices = ref.vi_slices(c, tpr)
    assert len(slices) == tpr
    assert sorted(torch.cat(slices).tolist()) == list(range(c))
    for sl in slices:
        assert bool((sl[1:] > sl[:-1]).all())
    if c % 4 == 0 and tpr < c // 4:
        assert slices[1][:5].tolist() == [4, 5, 6, 7, 4 * tpr + 4]


@pytest.mark.parametrize("coupling", ["shared", "independent"])
def test_vi_chain_ref_is_the_reference_sweep(env, coupling):
    """Four lanes on shared draws in one chain: ``repro``'s
    ``estimate_pi_sweep`` (its vmap) and the port's lane loop on the CPU."""
    grid = JGrid.product(_design("second_price"), env.budgets,
                         bid_scales=[1.0, 1.3], budget_scales=[1.0, 0.5])
    key = jax.random.PRNGKey(4)
    pi0 = jnp.full((4, N_CAMPAIGNS), 0.9, jnp.float32)
    kw = dict(sample_size=150, num_iters=6, batch_size=64, eta_decay=0.05,
              coupling=coupling)
    want = j_vi.estimate_pi_sweep(env.values, grid.budgets, grid.rules, key,
                                  pi0=pi0, **kw)
    values, t_grid = from_reference(env.values, grid.budgets,
                                    grid.rules.multipliers,
                                    grid.rules.reserve, grid.rules.kind,
                                    device="cpu")
    t_key = key_from_reference(np.asarray(key))
    loop = vi.estimate_pi_sweep(values, t_grid.budgets, t_grid.rules, t_key,
                                pi0=_t(pi0), **kw)
    draws, chain = _kernel_inputs(values, t_grid.budgets, t_key, **kw)
    got, _ = ref.vi_chain_ref(
        chain.sampled, draws.u, chain.step, chain.denom, chain.btilde,
        t_grid.rules.multipliers, t_grid.rules.reserve, _t(pi0),
        sample_size=150, second_price=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.pi))
    assert torch.equal(got, loop.pi)


def test_vi_cuda_refuses_cpu_tensors():
    one = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        vi_cuda(one, torch.ones((4, 2, 1)), torch.ones(4), torch.ones(1),
                one[:1], one[:1], torch.zeros(1), one[:1], sample_size=2,
                second_price=False)
