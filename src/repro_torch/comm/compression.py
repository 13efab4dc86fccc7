"""Gradient compression and explicit all-reduce means for the slow
cross-pod hop (port of ``repro.comm.compression``).

* **int8 block quantisation with error feedback**: a flat float32 vector
  is cut into blocks of :data:`BLOCK` values (the last zero-padded), each
  quantised to int8 against its largest magnitude over 127, the scale
  sent as bfloat16; the residual is carried to the next step. The bits
  are ``repro``'s: an IEEE divide, round half to even, a clip, and the
  scale rounded to bfloat16 (the int8 values are quantised against the
  float32 scale, as in ``repro``).
* **the ring all-reduce mean**: reduce-scatter, then all-gather, one chunk
  a hop to the next rank, by ``torch.distributed`` send and receive over a
  process group where ``repro`` uses ``ppermute`` over a mesh axis.
* **the compressed all-reduce mean**: every rank's int8 payload and
  bfloat16 scales all-gathered, then dequantised and averaged locally,
  the ranks added in rank order.

The process group is the one :func:`repro_torch.launch.mesh.
distributed_initialize` starts (gloo on the CPU, NCCL across cards), or
any subgroup of it; both gloo and NCCL carry the int8 values and the
bfloat16 scales as they are.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

BLOCK = 256
Tree = Any


def _div(x: torch.Tensor, k: float) -> torch.Tensor:
    """``x / k`` correctly rounded on every device: CUDA multiplies by the
    reciprocal of a host scalar divisor, which is not always the
    quotient's bits, so the divisor is a tensor on ``x``'s device."""
    return x / x.new_full((), k)


# ---------------------------------------------------------------------------
# int8 block quantisation with error feedback

def quantize_int8(x: torch.Tensor):
    """``x`` (flat, n) float32 -> ``(int8 values (blocks, BLOCK), bfloat16
    per-block scales (blocks, 1))``, n zero-padded to a multiple of
    :data:`BLOCK`."""
    n = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, (-n) % BLOCK)).reshape(-1, BLOCK)
    scale = _div(xp.abs().amax(dim=1, keepdim=True), 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xp / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    n: int) -> torch.Tensor:
    """The float32 values of :func:`quantize_int8`'s output, the first
    ``n``."""
    return (q.float() * scale.float()).reshape(-1)[:n]


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """``(q, scale, new_error)`` of ``grad`` (any shape) plus the running
    residual ``error`` (flat float32)."""
    flat = grad.reshape(-1).float() + error
    q, scale = quantize_int8(flat)
    new_error = flat - dequantize_int8(q, scale, flat.shape[0])
    return q, scale, new_error


# ---------------------------------------------------------------------------
# all-reduce means over a process group

def _ranks(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _shift(send: torch.Tensor, recv: torch.Tensor, n: int, me: int,
           group) -> None:
    """Send ``send`` to the next rank of the ring and receive ``recv`` from
    the previous one, as one batch (NCCL would deadlock on a ring of
    blocking sends). Gloo sends and receives host memory only: a card's
    tensors go through host copies."""
    right, left = (me + 1) % n, (me - 1) % n
    if group is not None:
        right = dist.get_global_rank(group, right)
        left = dist.get_global_rank(group, left)
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    out = send.cpu() if staged else send.contiguous()
    into = torch.empty(recv.shape, dtype=recv.dtype) if staged else recv
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out, right, group),
            dist.P2POp(dist.irecv, into, left, group)]):
        req.wait()
    if staged:
        recv.copy_(into)


def ring_all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The exact all-reduce mean of ``x`` over the ranks of ``group`` (the
    default group unless given) by a ring: n - 1 reduce-scatter hops, each
    adding the chunk received from the previous rank into this rank's,
    then n - 1 all-gather hops. ``x``'s size must divide into n chunks.
    ``x`` itself is left as it is."""
    n, me = _ranks(group)
    if n == 1:
        return x
    chunks = x.reshape(n, -1).clone()
    recv = torch.empty_like(chunks[0])
    for i in range(n - 1):
        _shift(chunks[(me - i) % n], recv, n, me, group)
        chunks[(me - i - 1) % n] += recv
    for i in range(n - 1):
        _shift(chunks[(me + 1 - i) % n], recv, n, me, group)
        chunks[(me - i) % n] = recv
    return _div(chunks, n).reshape(x.shape)


def compressed_all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The all-reduce mean of ``x`` over ``group`` where every rank sends
    its int8 values and bfloat16 scales: one all-gather of each, then
    every rank's dequantised vector added in rank order and divided by n.
    Returns float32 in ``x``'s shape."""
    n, _ = _ranks(group)
    if n == 1:
        return x
    flat = x.reshape(-1).float()
    q, scale = quantize_int8(flat)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = None
    for qr, sr in zip(qs, ss):
        recon = qr.float() * sr.float()
        total = recon if total is None else total + recon
    return _div(total, n).reshape(-1)[:flat.shape[0]].reshape(x.shape)


def _tree_map(fn, tree: Tree) -> Tree:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def make_cross_pod_grad_mean(mesh, compressed: bool = True):
    """``grads -> grads`` averaged over the ``"pod"`` axis of ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`, or anything with
    ``axis_names``): the identity without one. Otherwise each leaf of the
    tree (a tensor, or dicts, lists and tuples of them) is averaged over
    the processes of the pod axis, the default process group:
    :func:`compressed_all_reduce_mean`, or with ``compressed`` false the
    exact mean (an all-reduce sum over n, ``repro``'s ``pmean``)."""
    if "pod" not in mesh.axis_names:
        return lambda tree: tree

    def exact(g):
        total = g.clone()
        dist.all_reduce(total)
        return _div(total, dist.get_world_size())

    def one(g):
        return compressed_all_reduce_mean(g) if compressed else exact(g)

    return lambda tree: _tree_map(one, tree)
