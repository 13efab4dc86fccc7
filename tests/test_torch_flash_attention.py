"""The flash-attention kernel's plain versions against ``repro``'s Pallas
kernel (interpret mode on the CPU, as ``repro.kernels.flash_attention.ops``
picks off a TPU), at ``tests/test_kernels.py``'s cases and tolerances,
plus a window without causal masking and an S that no power of two >= 64
divides.

The CUDA kernel itself runs only on a card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as cuda_fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b, s, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))]


def _port(x, dtype):
    return torch.from_numpy(x).to(dtype)


CASES = [   # tests/test_kernels.py:245-251, then the two added cases
    (2, 256, 4, 2, 64, True, None, "float32"),
    (1, 512, 2, 2, 64, True, 128, "float32"),
    (2, 128, 4, 1, 32, False, None, "bfloat16"),
    (1, 384, 3, 3, 128, True, None, "float32"),
    (1, 64, 2, 2, 16, True, 16, "float32"),
    (2, 192, 4, 2, 32, False, 40, "float32"),     # window, not causal
    (1, 200, 4, 2, 32, True, 24, "bfloat16"),     # S = 8 * 25
]


@pytest.mark.parametrize("b,s,h,kv,dh,causal,window,dtype", CASES)
def test_plain_version_matches_the_pallas_kernel(b, s, h, kv, dh, causal,
                                                 window, dtype):
    q, k, v = _qkv(b, s, h, kv, dh, seed=s + h)
    want = j_flash(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                   jnp.asarray(v, dtype), causal=causal, window=window,
                   block_q=128, block_k=128)
    tdt = getattr(torch, dtype)
    got = ops.flash_attention(_port(q, tdt), _port(k, tdt), _port(v, tdt),
                              causal=causal, window=window)
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, dh)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None), (False, 16)])
def test_folded_oracle_matches_the_reference_oracle(causal, window):
    """``flash_attention_ref`` on (BH, S, dh), the Pallas kernel's layout,
    is ``repro``'s oracle to float32 rounding."""
    q, k, v = (x.reshape(6, 96, 32) for x in _qkv(1, 96, 6, 6, 32, seed=3))
    want = j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 causal=causal, window=window)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("h,kv", [(4, 1), (6, 3), (8, 2)])
def test_grouped_heads_are_the_repeated_heads(h, kv):
    """The GQA entry equals the plain version on kv heads repeated as
    ``jnp.repeat`` lays them out: query head i reads kv head i // (H/KV)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 80, h, kv, 16, seed=h))
    got = ops.flash_attention(q, k, v, window=20)
    rep = h // kv
    want = ref.attention_ref(q, k.repeat_interleave(rep, 2),
                             v.repeat_interleave(rep, 2), window=20)
    assert torch.equal(got, want)
    one_head = ref.flash_attention_ref(
        q[:, :, 5 % h].contiguous(), k[:, :, (5 % h) // rep].contiguous(),
        v[:, :, (5 % h) // rep].contiguous(), window=20)
    assert torch.equal(got[:, :, 5 % h], one_head)


def test_the_reference_scale_is_the_float32_one():
    """The Pallas kernel scales by the Python double ``1/dh**0.5`` cast to
    float32; the oracle (and the CUDA kernel) by ``1/sqrtf(dh)`` in
    float32. The two are the same float32 for every head dim the kernel
    takes."""
    for dh in cuda_fa.HEAD_DIMS:
        assert np.float32(1.0 / dh ** 0.5) == \
            np.float32(1.0) / np.sqrt(np.float32(dh))


def test_a_cuda_wrapper_refuses_what_it_cannot_launch():
    """The wrapper launches or raises: a CPU tensor, an unsupported head
    dim or dtype, ungrouped heads or a window below 1 are refused before
    the library is built, and nothing is counted."""
    cuda_fa.reset_launches()
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fa.flash_attention_cuda(q, q, q)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="head dims"):
        cuda_fa.flash_attention_cuda(*[torch.empty(1, 8, 2, 48, **meta)] * 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_fa.flash_attention_cuda(*[torch.empty(
            1, 8, 2, 64, dtype=torch.float16, **meta)] * 3)
    with pytest.raises(ValueError, match="kv heads"):
        cuda_fa.flash_attention_cuda(torch.empty(1, 8, 3, 64, **meta),
                                     *[torch.empty(1, 8, 2, 64, **meta)] * 2)
    with pytest.raises(ValueError, match="window"):
        cuda_fa.flash_attention_cuda(*[torch.empty(1, 8, 2, 64, **meta)] * 3,
                                     window=0)
    assert cuda_fa.LAUNCHES == {"flash_attention": 0}


BF16_LIMITS = {   # the bf16 tensor-core route: (q, k, v), what it raises
    # 8,388,609 rows are 65,536 query tiles of 128, one past gridDim.y
    "query tiles at dh=64": (
        [torch.empty(1, 65535 * 128 + 1, 1, 64, dtype=torch.bfloat16,
                     device="meta")] * 3, "grid limit"),
    # dh=256 takes 64-row tiles, so half that S is already too long
    "query tiles at dh=256": (
        [torch.empty(1, 65535 * 64 + 1, 1, 256, dtype=torch.bfloat16,
                     device="meta")] * 3, "grid limit"),
    # B*H is the grid's x axis of both kernels now, not bounded by
    # 65,535: float32 meta tensors past the old float32 grid pass every
    # limit and are refused only as not on a card
    "B*H beyond the float32 grid": (
        [torch.empty(65536, 4, 1, 64, dtype=torch.float32,
                     device="meta")] * 3, "CUDA tensors, got meta"),
    "an unaligned q": (
        [torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(
            2, 8, 2, 64)] + [torch.zeros(2, 8, 2, 64,
                                         dtype=torch.bfloat16)] * 2,
        "q must start on a 16-byte boundary"),
    "an unaligned v": (
        [torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16)] * 2
        + [torch.zeros(2 * 8 * 2 * 64 + 4, dtype=torch.bfloat16)[4:].view(
            2, 8, 2, 64)], "v must start on a 16-byte boundary"),
    "head dim 48": (
        [torch.empty(1, 8, 2, 48, dtype=torch.bfloat16, device="meta")] * 3,
        "head dims"),
}


@pytest.mark.parametrize("case", sorted(BF16_LIMITS))
def test_the_bf16_route_refuses_what_it_cannot_launch(case):
    """The bf16 tensor-core kernel's own limits: its grid's y axis counts
    query tiles of ``ROWS[dh]`` rows, and its 16-byte copies need
    tensors that start on a 16-byte boundary. Each is refused before the
    library is built, and nothing is counted. (The float32 kernel shares
    the grid: B*H is not bounded in either.)"""
    cuda_fa.reset_launches()
    qkv, match = BF16_LIMITS[case]
    with pytest.raises(ValueError, match=match):
        cuda_fa.flash_attention_cuda(*qkv)
    assert cuda_fa.LAUNCHES == {"flash_attention": 0}


F32_LIMITS = {   # the float32 split-TF32 route: (q, k, v), what it raises
    "query tiles at dh=64": (
        [torch.empty(1, 65535 * 128 + 1, 1, 64, device="meta")] * 3,
        "grid limit"),
    "query tiles at dh=256": (
        [torch.empty(1, 65535 * 64 + 1, 1, 256, device="meta")] * 3,
        "grid limit"),
    "an unaligned k": (
        [torch.zeros(2, 8, 2, 32)] + [torch.zeros(
            2 * 8 * 2 * 32 + 2)[2:].view(2, 8, 2, 32)] + [torch.zeros(
                2, 8, 2, 32)], "k must start on a 16-byte boundary"),
}


@pytest.mark.parametrize("case", sorted(F32_LIMITS))
def test_the_float32_route_refuses_what_it_cannot_launch(case):
    """The float32 kernel copies 16 bytes at a time and counts query tiles
    of ``ROWS[dh]`` rows on its grid's y axis, as the bf16 kernel does;
    B*H is its x axis. Each limit is refused before the library is built,
    and nothing is counted."""
    cuda_fa.reset_launches()
    qkv, match = F32_LIMITS[case]
    with pytest.raises(ValueError, match=match):
        cuda_fa.flash_attention_cuda(*qkv)
    assert cuda_fa.LAUNCHES == {"flash_attention": 0}


SPLIT_TF32_SHAPES = [   # chip_smoke.py's float32 rows at CPU sizes
    (2, 256, 4, 2, 64, True, None),      # tests/test_kernels.py
    (1, 512, 2, 2, 64, True, 128),
    (1, 384, 3, 3, 128, True, None),
    (1, 64, 2, 2, 16, True, 16),
    (1, 256, 8, 8, 64, True, None),      # stablelm's prefill, cut
    (2, 192, 4, 2, 32, False, 40),       # dh=32, a window, not causal
    (1, 160, 2, 1, 256, True, 77),       # dh=256, a window cutting a tile
    (2, 200, 4, 2, 128, True, None),     # ragged S
    (1, 300, 16, 2, 64, True, 77),       # GQA 8:1, a window cutting a tile
    (16385, 8, 4, 1, 16, True, None),    # B*H = 65,540, past the old grid
]


@pytest.mark.parametrize("b,s,h,kv,dh,causal,window", SPLIT_TF32_SHAPES)
def test_split_tf32_holds_the_float32_tolerance(b, s, h, kv, dh, causal,
                                                window):
    """The float32 kernel's arithmetic on the CPU: split TF32 products and
    its kv-tile order (``ref.attention_split_tf32_ref``) stay within the
    float32 tolerance (2e-5) of ``repro``'s attention oracle on kv heads
    repeated as ``jnp.repeat`` lays them out."""
    q, k, v = _qkv(b, s, h, kv, dh, seed=s + h + dh)
    got = ref.attention_split_tf32_ref(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal,
                                       window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, s, h, dh)

    def fold(x):
        return np.repeat(x, h // x.shape[2], axis=2).transpose(
            0, 2, 1, 3).reshape(b * h, s, dh)

    want = j_ref(jnp.asarray(fold(q)), jnp.asarray(fold(k)),
                 jnp.asarray(fold(v)), causal=causal, window=window)
    want = np.asarray(want).reshape(b, h, s, dh).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_tf32_rounding_is_to_nearest_ties_away():
    """``ref.round_tf32`` keeps 10 mantissa bits, rounds to nearest and a
    tie away from zero (``cvt.rna``), and the split hi + lo carries the
    22 leading bits of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, 1.0 + 3 * ulp / 4,
                      -(1.0 + ulp / 2), 3.14159265, 2.0 ** -100, 0.0],
                     dtype=torch.float32)
    want = [1.0, 1.0 + ulp, 1.0, 1.0 + ulp, -(1.0 + ulp), 3.140625,
            2.0 ** -100, 0.0]
    assert ref.round_tf32(x).tolist() == want
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi = ref.round_tf32(y)
    lo = ref.round_tf32(y - hi)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


def test_a_non_cpu_tensor_goes_to_the_kernel_not_the_plain_version(
        monkeypatch):
    """Only a CPU tensor takes the plain version. A meta tensor (the dry
    run) takes the wrappers' meta route: empty outputs, nothing computed;
    the CUDA wrapper raises for a tensor that is not on a card."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran")
    for name in ("attention_ref", "attention_lse_ref"):
        monkeypatch.setattr(ops, name, plain)
    q = torch.empty(1, 8, 2, 64, device="meta")
    out = ops.flash_attention(q, q, q)
    assert (out.shape, out.device.type) == (q.shape, "meta")
    with pytest.raises(ValueError, match="CUDA tensors, got meta"):
        cuda_fa.flash_attention_cuda(q, q, q)
