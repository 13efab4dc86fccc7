"""The fused-round kernels' plain versions against ``repro``'s oracles and
its Pallas kernels (interpret mode), and the CUDA wrappers' contract.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold them against these plain versions there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.auction_resolve import ops as j_ops  # noqa: E402
from repro.kernels.auction_resolve import ref as j_ref  # noqa: E402
from repro_torch.kernels.auction_resolve import ops as t_ops  # noqa: E402
from repro_torch.kernels.auction_resolve import ref as t_ref  # noqa: E402
from repro_torch.kernels.auction_resolve import round_fused as cuda_rf  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G = 32


def _fused_inputs(s, n, c, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        values=rng.uniform(0.0, 1.0, (n, c)).astype(np.float32),
        mult=rng.uniform(0.5, 1.5, (s, c)).astype(np.float32),
        act=rng.uniform(size=(s, c)) < 0.8,
        res=rng.uniform(0.0, 0.05, s).astype(np.float32),
        b=rng.uniform(2.0, 20.0, (s, c)).astype(np.float32),
        s_hat=rng.uniform(0.0, 1.0, (s, c)).astype(np.float32),
        n_hat=(np.arange(s, dtype=np.int32) * (n // (2 * s))),
    )


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


CASES = [
    (1, 512, 40, False),
    (5, 1000, 33, True),         # ragged N and C
    (8, 768, 17, False),
    (4, 300, 7, True),           # N < canonical grid coverage
]


@pytest.mark.parametrize("s,n,c,sp", CASES)
def test_round_fused_ref_bit_identical_to_reference_oracle(s, n, c, sp):
    x = _fused_inputs(s, n, c)
    block = -(-n // G)
    j_out = j_ref.round_fused_ref(
        jnp.asarray(x["values"]), jnp.asarray(x["mult"]),
        jnp.asarray(x["act"]), jnp.asarray(x["res"]), jnp.asarray(x["b"]),
        jnp.asarray(x["s_hat"]), jnp.asarray(x["n_hat"]), block_size=block,
        reduce_blocks=G, second_price=sp)
    t_out = t_ref.round_fused_ref(
        _t(x["values"]), _t(x["mult"]), _t(x["act"]), _t(x["res"]),
        _t(x["b"]), _t(x["s_hat"]), _t(x["n_hat"]), block_size=block,
        reduce_blocks=G, second_price=sp)
    for name, a, b in zip(("rate_parts", "block_parts", "c_next", "no_cap",
                           "n_next"), j_out, t_out):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("offset,n_global", [(0, 2048), (512, 2048),
                                             (1536, 2048)])
def test_fused_partials_ref_bit_identical_with_offset(offset, n_global):
    x = _fused_inputs(4, n_global, 20)
    v_local = x["values"][offset:offset + 512]
    lo = x["n_hat"]
    hi = np.full_like(lo, n_global - 100)
    block = -(-n_global // G)
    j_parts = j_ref.fused_partials_ref(
        jnp.asarray(v_local), jnp.asarray(x["mult"]), jnp.asarray(x["act"]),
        jnp.asarray(x["res"]), jnp.asarray(lo), jnp.asarray(hi),
        block_size=block, reduce_blocks=G, second_price=True,
        index_offset=offset)
    t_parts = t_ref.fused_partials_ref(
        _t(v_local), _t(x["mult"]), _t(x["act"]), _t(x["res"]), _t(lo),
        _t(hi), block_size=block, reduce_blocks=G, second_price=True,
        index_offset=offset)
    np.testing.assert_array_equal(np.asarray(j_parts), t_parts.numpy())


@pytest.mark.parametrize("s,n,c,sp", CASES)
def test_ops_round_fused_matches_pallas_interpret(s, n, c, sp):
    """The port's wrapper on CPU tensors against repro's Pallas round
    kernel in interpret mode. Partials at rtol/atol 1e-5, the tolerance
    repro's own kernel test uses: the Pallas kernel sums each tile through
    a one-hot matmul, not in event order. Integers exact."""
    x = _fused_inputs(s, n, c)
    j_out = j_ops.round_fused(
        jnp.asarray(x["values"]), jnp.asarray(x["mult"]),
        jnp.asarray(x["act"]), jnp.asarray(x["res"]), jnp.asarray(x["b"]),
        jnp.asarray(x["s_hat"]), jnp.asarray(x["n_hat"]),
        jnp.ones((s,), bool), reduce_blocks=G, second_price=sp, block_t=128,
        interpret=True)
    t_out = t_ops.round_fused(
        _t(x["values"]), _t(x["mult"]), _t(x["act"]), _t(x["res"]),
        _t(x["b"]), _t(x["s_hat"]), _t(x["n_hat"]),
        torch.ones(s, dtype=torch.bool), reduce_blocks=G, second_price=sp)
    for a, b in zip(j_out[:2], t_out[:2]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for a, b in zip(j_out[2:], t_out[2:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("offset,ndev", [(0, 1), (512, 4), (1536, 4)])
def test_ops_sweep_partials_matches_pallas_interpret(offset, ndev):
    s, n_global, c = 4, 2048, 20
    local_n = n_global // ndev
    x = _fused_inputs(s, n_global, c)
    v_local = x["values"][offset:offset + local_n]
    hi = np.full_like(x["n_hat"], n_global)
    j_parts = j_ops.sweep_partials(
        jnp.asarray(v_local), jnp.asarray(x["mult"]), jnp.asarray(x["act"]),
        jnp.asarray(x["res"]), jnp.asarray(x["n_hat"]), jnp.asarray(hi),
        jnp.ones((s,), bool), jnp.int32(offset), n_events_global=n_global,
        reduce_blocks=G, block_t=256, interpret=True)
    t_parts = t_ops.sweep_partials(
        _t(v_local), _t(x["mult"]), _t(x["act"]), _t(x["res"]),
        _t(x["n_hat"]), _t(hi), torch.ones(s, dtype=torch.bool), offset,
        n_events_global=n_global, reduce_blocks=G)
    np.testing.assert_allclose(np.asarray(j_parts), t_parts.numpy(),
                               rtol=1e-5, atol=1e-5)
    # blocks outside this slice of the log are exact zeros
    block = -(-n_global // G)
    g_lo, g_hi = offset // block, (offset + local_n - 1) // block
    outside = np.ones(G, bool)
    outside[g_lo:g_hi + 1] = False
    assert not t_parts.numpy()[:, outside].any()


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; a CPU tensor is refused before
    any build is attempted."""
    x = _fused_inputs(2, 256, 8)
    args = [_t(x[k]) for k in ("values", "mult", "act", "res")]
    lo = _t(x["n_hat"])
    alive = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rf.sweep_partials_cuda(
            *args, lo, None, alive, offset=0, n_global=256, block_size=8,
            reduce_blocks=G, second_price=False, skip_retired=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_rf.round_fused_cuda(
            *args, _t(x["b"]), _t(x["s_hat"]), lo, alive, block_size=8,
            reduce_blocks=G, second_price=False, skip_retired=True)


def test_cpu_dispatch_never_counts_a_launch():
    cuda_rf.reset_launches()
    x = _fused_inputs(3, 400, 9)
    t_ops.round_fused(
        _t(x["values"]), _t(x["mult"]), _t(x["act"]), _t(x["res"]),
        _t(x["b"]), _t(x["s_hat"]), _t(x["n_hat"]),
        torch.ones(3, dtype=torch.bool), reduce_blocks=G)
    assert cuda_rf.LAUNCHES == {"round_fused": 0, "sweep_partials": 0}
