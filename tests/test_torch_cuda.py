"""The fused-round CUDA kernels against their plain versions, on a card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a CUDA device. This file imports neither ``jax`` nor
``repro``, so it also runs where only PyTorch is installed (then without
the JAX-importing ``tests/conftest.py``):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Event-ordered sums make the kernels bitwise the plain versions on the CPU.
The plain versions on the card sum with atomics, so against those the
partials are only close.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import AuctionRule, sweep_state_machine  # noqa: E402
from repro_torch.core.segments import REDUCE_BLOCKS as G  # noqa: E402
from repro_torch.data import make_synthetic_env  # noqa: E402
from repro_torch.kernels.auction_resolve import ops, ref  # noqa: E402
from repro_torch.kernels.auction_resolve import round_fused as cuda_rf  # noqa: E402

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
