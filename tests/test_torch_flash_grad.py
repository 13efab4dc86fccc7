"""The gradient of the port's attention against ``repro``'s on the CPU:
the plain forward and backward behind
``repro_torch.kernels.flash_attention.ops.FlashAttention`` (what the CPU
runs where the card runs ``csrc/flash_attention.cu`` with its logsumexp
and then ``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of
``repro.models.attention.causal_attention``, causal, windowed, GQA and
not causal, in bfloat16 and float32; and the plain backward against
autograd through plain float64 attention.

The bounds, ``max |port - repro| / max |repro|`` over a tensor: 2e-6 in
float32 (measured <= 5.5e-7: only the order of the float32 sums differs)
and 2e-2 in bfloat16 (measured <= 8.5e-3: the reference rounds its scores
and probabilities to bfloat16, ``u = 2^-9``, where the port's plain
version keeps them in float32 and rounds each gradient once).

The card's bfloat16 backward kernels feed their tensor cores P and dS
rounded once to bfloat16; ``ref.attention_bwd_bf16_ref`` repeats those
roundings on the CPU, and is held here against ``jax.vjp`` within the same
2e-2 and against the plain backward within ``chip_smoke.py``'s ``BWD_TOL``
(2e-2), at each case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import causal_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd as cuda_fab  # noqa: E402

import torch_lm_reference as lm_ref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATTENTION_CASES = [   # b, s, h, kv, dh, causal, window
    (2, 32, 4, 4, 32, True, None),
    (2, 32, 4, 2, 32, True, 8),
    (2, 40, 6, 2, 16, True, None),
    (2, 24, 4, 4, 32, False, None),
    (1, 20, 4, 1, 64, False, 5),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,h,kv,dh,causal,window", ATTENTION_CASES)
def test_attention_gradient_is_jax_vjp(b, s, h, kv, dh, causal, window,
                                       dtype):
    rng = np.random.default_rng(s + dh)
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in
                   ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh),
                    (b, s, h, dh)))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(
        lambda q, k, v: causal_attention(q, k, v, window=window,
                                         causal=causal),
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jd))
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    got_out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(got_out, leaves, torch.from_numpy(do).to(td))
    tol = 2e-2 if dtype == "bfloat16" else 2e-6
    assert lm_ref.rel(got_out.detach(), out) <= tol
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == td
        assert lm_ref.rel(g, w) <= tol, name


def _bf16_inputs(b, s, h, kv, dh):
    rng = np.random.default_rng(s + dh)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(torch.bfloat16) for shape in
            ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh))]


@pytest.mark.parametrize("b,s,h,kv,dh,causal,window", ATTENTION_CASES)
def test_bf16_mirror_is_jax_vjp(b, s, h, kv, dh, causal, window):
    """The mirror of the bfloat16 kernels' roundings, from the plain
    forward's output and logsumexp, against ``jax.vjp`` of ``repro``'s
    attention on the same bfloat16 inputs, within 2e-2 (measured <=
    8.3e-3)."""
    q, k, v, do = _bf16_inputs(b, s, h, kv, dh)
    _, vjp = jax.vjp(
        lambda q, k, v: causal_attention(q, k, v, window=window,
                                         causal=causal),
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    out, lse = ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    got = ref.attention_bwd_bf16_ref(q, k, v, out, do, lse, causal=causal,
                                     window=window)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        assert lm_ref.rel(g, w) <= 2e-2, name


@pytest.mark.parametrize("b,s,h,kv,dh,causal,window", ATTENTION_CASES)
def test_bf16_mirror_is_the_plain_backward(b, s, h, kv, dh, causal, window):
    """The mirror against the plain backward on the same bfloat16 inputs,
    within ``BWD_TOL``'s 2e-2 (measured <= 6.2e-3), and not equal to it:
    its roundings of P and dS move the gradients."""
    q, k, v, do = _bf16_inputs(b, s, h, kv, dh)
    out, lse = ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    args = (q, k, v, out, do, lse)
    got = ref.attention_bwd_bf16_ref(*args, causal=causal, window=window)
    want = ref.attention_bwd_ref(*args, causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        assert lm_ref.rel(g, w.float()) <= 2e-2, name
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("b,s,h,kv,dh,causal,window", ATTENTION_CASES)
def test_plain_backward_is_autograd_in_float64(b, s, h, kv, dh, causal,
                                               window):
    """``ref.attention_bwd_ref`` (the kernel's plain version: P from the
    saved logsumexp, D = rowsum(dO O), the group's heads summed onto their
    kv head) against autograd through plain attention in float64, within
    float32's precision (1e-5), and no kernel launched on the CPU."""
    gen = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64)
               for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    do = torch.randn((b, s, h, dh), generator=gen, dtype=torch.float64)
    out, lse = ref.attention_lse_ref(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    got = ref.attention_bwd_ref(q.float(), k.float(), v.float(), out,
                                do.float(), lse, causal=causal,
                                window=window)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    rep = h // kv
    kk, vv = (x.repeat_interleave(rep, dim=2) for x in leaves[1:])
    scores = torch.einsum("bqhd,bkhd->bhqk", leaves[0], kk) / dh ** 0.5
    seen = ref.seen(s, causal=causal, window=window, device="cpu")
    probs = torch.softmax(scores.masked_fill(~seen, -torch.inf), dim=-1)
    want_out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    want = torch.autograd.grad(want_out, leaves, do)
    assert lm_ref.rel(out, want_out.detach()) <= 1e-5
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape and lm_ref.rel(g, w) <= 1e-5, name
    assert cuda_fab.LAUNCHES["flash_attention_bwd"] == 0


def test_backward_wrapper_refuses_what_the_kernel_cannot_take():
    """The backward kernel's wrapper checks its arguments as the forward's
    does, before anything is built or launched: a head dim the kernels do
    not take, heads that do not group, and tensors not on a card."""
    meta = dict(device="meta", dtype=torch.bfloat16)

    def call(q, k):
        lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                          device=q.device)
        cuda_fab.flash_attention_bwd_cuda(q, k, k, q, q, lse)

    with pytest.raises(ValueError, match="head dims"):
        call(torch.empty(1, 8, 2, 48, **meta), torch.empty(1, 8, 2, 48, **meta))
    with pytest.raises(ValueError, match="do not group"):
        call(torch.empty(1, 8, 3, 64, **meta), torch.empty(1, 8, 2, 64, **meta))
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64))
    assert cuda_fab.LAUNCHES["flash_attention_bwd"] == 0
