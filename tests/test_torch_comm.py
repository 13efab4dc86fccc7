"""The port's gradient compression and all-reduce means (``repro_torch.
comm``) against ``repro.comm`` on the CPU.

The int8 block quantisation, its inverse and the error-feedback step are
``repro``'s bit for bit (run eagerly and compiled): hypothesis-drawn
float32 vectors whose lengths are not multiples of the 256-value block,
zeros, huge and tiny values, and a residual carried over 5 steps. The two
all-reduce means run in 2 and 4 ``torch.distributed`` processes over gloo,
started as ``tests/test_torch_multihost.py`` starts them: the ring within
float32 rounding of the exact mean, the compressed mean bitwise the mean
of every rank's ``repro`` quantise/dequantise, added in rank order, and
``make_cross_pod_grad_mean`` over a mesh with a ``"pod"`` axis either
way. Without a ``"pod"`` axis it is the identity.
"""
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
import hypothesis.extra.numpy as hnp  # noqa: E402

from repro.comm import compression as j_comm  # noqa: E402
from repro_torch import comm  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
BLOCK = comm.compression.BLOCK
LENGTH = 3 * BLOCK * 4 + 4 * 37      # divides into 2 and 4 ring chunks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J_QUANTIZE = jax.jit(j_comm.quantize_int8)


def assert_quantized_as_repro(x: np.ndarray):
    q, scale = comm.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.bfloat16
    for jq, js in (j_comm.quantize_int8(jnp.asarray(x)),
                   J_QUANTIZE(jnp.asarray(x))):
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.view(torch.int16).numpy(),
                                      np.asarray(js).view(np.int16))
    got = comm.dequantize_int8(q, scale, x.shape[0])
    want = j_comm.dequantize_int8(jq, js, x.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


lengths = st.integers(1, 6 * BLOCK).filter(lambda n: n % BLOCK)


@settings(deadline=None, max_examples=30, derandomize=True)
@given(lengths.flatmap(lambda n: hnp.arrays(
    np.float32, (n,), elements=st.floats(-1e6, 1e6, width=32))))
def test_quantize_is_repros_bits(x):
    assert_quantized_as_repro(x)


@pytest.mark.parametrize("case", ["zeros", "huge", "tiny", "mixed",
                                  "one_block_zero"])
def test_quantize_edges_are_repros_bits(case):
    """Zeros (the scale's 1e-12 floor), values near float32's largest and
    smallest, magnitudes mixed across a block, a zero block among others."""
    rng = np.random.default_rng(0)
    n = 3 * BLOCK + 17
    x = {"zeros": np.zeros(n),
         "huge": rng.uniform(-3.4e38, 3.4e38, n),
         "tiny": rng.standard_normal(n) * 1e-40,
         "mixed": rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n),
         "one_block_zero": np.concatenate([rng.standard_normal(BLOCK),
                                           np.zeros(BLOCK),
                                           rng.standard_normal(n - 2 * BLOCK)
                                           ])}[case].astype(np.float32)
    assert_quantized_as_repro(x)


def test_error_feedback_over_five_steps_is_repros():
    """``compress_with_feedback`` with its residual carried from step to
    step: every step's values, scales and residual bitwise ``repro``'s."""
    rng = np.random.default_rng(1)
    n = 5 * BLOCK - 3
    error_t = torch.zeros(n)
    error_j = jnp.zeros(n, jnp.float32)
    step = jax.jit(j_comm.compress_with_feedback)
    for i in range(5):
        grad = (rng.standard_normal(n) * 10.0 ** -i).astype(np.float32)
        q, scale, error_t = comm.compress_with_feedback(
            torch.from_numpy(grad), error_t)
        jq, js, error_j = step(jnp.asarray(grad), error_j)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.view(torch.int16).numpy(),
                                      np.asarray(js).view(np.int16))
        np.testing.assert_array_equal(error_t.numpy(), np.asarray(error_j))
    assert float(error_t.abs().max()) > 0


def test_cross_pod_mean_is_the_identity_without_a_pod_axis():
    """No ``"pod"`` axis: the tree comes back as it is, with no process
    group started."""
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    grads = {"a": torch.randn(5), "b": {"c": torch.randn(3, 4)}}
    for compressed in (True, False):
        assert comm.make_cross_pod_grad_mean(mesh, compressed)(grads) \
            is grads


WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    torch.set_num_threads(1)
    rank, world, address, inputs, outputs = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
    from repro_torch import comm
    from repro_torch.launch.mesh import distributed_initialize, make_mesh
    assert distributed_initialize(address, world, rank,
                                  device="cpu") == "gloo"
    x = torch.from_numpy(np.load(inputs)[f"rank{rank}"])
    keep = x.clone()
    mesh = make_mesh((world,), ("pod",), devices=["cpu"] * world)
    tree = {"w": x.reshape(-1, 4), "b": [x[:100]]}
    exact = comm.make_cross_pod_grad_mean(mesh, compressed=False)(tree)
    packed = comm.make_cross_pod_grad_mean(mesh)(tree)
    out = dict(ring=comm.ring_all_reduce_mean(x).numpy(),
               compressed=comm.compressed_all_reduce_mean(x).numpy(),
               pod_exact_w=exact["w"].numpy(),
               pod_exact_b=exact["b"][0].numpy(),
               pod_compressed_w=packed["w"].numpy(),
               pod_compressed_b=packed["b"][0].numpy())
    assert torch.equal(x, keep)
    np.savez(outputs, **out)
    torch.distributed.destroy_process_group()
    print("COMM_OK", rank)
""")


def compressed_mean(xs):
    """The mean of every rank's ``repro`` quantise/dequantise, added in
    rank order, float32."""
    total = None
    for x in xs:
        q, scale = j_comm.quantize_int8(jnp.asarray(x.reshape(-1)))
        recon = np.asarray(j_comm.dequantize_int8(q, scale, x.size))
        total = recon if total is None else total + recon
    return (total / np.float32(len(xs))).reshape(xs[0].shape)


@pytest.mark.parametrize("world", [2, 4])
def test_all_reduce_means_over_gloo_processes(tmp_path, world):
    """``world`` processes, each with its own vector: every rank gets the
    ring mean within float32 rounding of the exact mean, and the
    compressed mean bitwise ``repro``'s quantise/dequantise of each rank's
    vector, averaged in rank order; ``make_cross_pod_grad_mean`` over a
    ``"pod"`` mesh gives the same per leaf (exact: the all-reduce sum over
    n, within the same rounding)."""
    rng = np.random.default_rng(world)
    xs = [(rng.standard_normal(LENGTH) * (1 + r)).astype(np.float32)
          for r in range(world)]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **{f"rank{r}": x for r, x in enumerate(xs)})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(world), address,
         str(inputs), str(tmp_path / f"rank{rank}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(world)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}: {stderr[-3000:]}"
        assert f"COMM_OK {rank}" in stdout
    exact = np.mean(np.stack(xs).astype(np.float64), axis=0)
    # each ring sum adds world - 1 float32 roundings, the mean one more
    tol = world * np.finfo(np.float32).eps * np.abs(np.stack(xs)).sum(0)
    want_compressed = compressed_mean(xs)
    for rank in range(world):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            for key, part in (("ring", slice(None)),
                              ("pod_exact_w", slice(None)),
                              ("pod_exact_b", slice(0, 100))):
                value = got[key].reshape(-1)
                assert value.dtype == np.float32
                assert (np.abs(value - exact[part]) <= tol[part]).all(), key
            np.testing.assert_array_equal(got["compressed"],
                                          want_compressed)
            np.testing.assert_array_equal(got["pod_compressed_w"].reshape(-1),
                                          want_compressed)
            np.testing.assert_array_equal(
                got["pod_compressed_b"], compressed_mean([x[:100]
                                                          for x in xs]))
