"""int8 wire compression for all-reduces over a mesh axis.

Counterpart of ``repro.optim.grad_compression``, over a ``torch.distributed``
group of a :class:`repro_torch.core.distributed.Mesh` in place of a
``shard_map`` axis. ``compressed_psum`` is a wire-level int8 all-reduce,
step by step the reference's:

  1. quantize locally with a shared scale (one scalar all-reduce MAX),
  2. int8 ``all_to_all_single`` (the reduce-scatter phase: each rank
     receives its 1/n chunk from every rank and accumulates it in int32,
     which cannot overflow: n * 127 << 2^31),
  3. requantize the reduced chunk under a fresh shared scale and int8
     all-gather it.

Every step is IEEE f32 or integer arithmetic in the reference's order, and
``torch.round`` rounds half to even as ``jnp.round`` does, so the result is
the reference's bits. Wire bytes: 2 (n-1)/n * size * 1 B, a quarter of an
f32 ring all-reduce. ``compressed_psum_ef`` adds error feedback: the f32
quantization residual is carried to the next call, which makes the long-run
average unbiased (EF-SGD).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["compressed_psum", "ErrorFeedback", "compressed_psum_ef",
           "quantize"]


def _shared_scale(v, mesh, axis, tag):
    """max |v| over the `axis` group, clamped away from 0, over 127."""
    absmax = v.abs().max().reshape(1)
    mesh.all_reduce(absmax, axis, op=dist.ReduceOp.MAX, tag=tag)
    return torch.clamp_min(absmax, 1e-20) / 127.0


def quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compressed_psum(x, mesh, axis, tag=None):
    """int8-wire sum of `x` over one or more `mesh` axes; f32, x's shape.

    ``axis`` is an axis name or a tuple of names. A multi-axis sum runs as
    nested single-axis sums, each requantizing, so its worst-case error
    grows with the number of axes. Every rank of the group calls it in the
    same order; ``tag`` names its payload in ``mesh.payload``.
    """
    if isinstance(axis, (tuple, list)):
        for a in axis:
            x = compressed_psum(x, mesh, a, tag)
        return x
    n = mesh.size(axis)
    shape, size = x.shape, x.numel()
    flat = x.to(torch.float32).reshape(-1)
    pad = (-size) % n
    if pad:
        flat = F.pad(flat, (0, pad))
    s1 = _shared_scale(flat, mesh, axis, tag)
    q = quantize(flat, s1)
    # reduce-scatter phase: int8 on the wire, int32 accumulation locally
    recv = mesh.all_to_all_single(q, axis, tag=tag).view(n, -1)
    chunk = recv.to(torch.int32).sum(0).to(torch.float32) * s1
    # requantize the reduced chunk with a fresh shared scale, then gather
    s2 = _shared_scale(chunk, mesh, axis, tag)
    q2 = quantize(chunk, s2)
    out = mesh.all_gather_cat(q2, axis, tag=tag).to(torch.float32) * s2
    return out[:size].reshape(shape)


class ErrorFeedback(NamedTuple):
    residual: torch.Tensor

    @classmethod
    def init(cls, x):
        return cls(residual=torch.zeros_like(x, dtype=torch.float32))


def compressed_psum_ef(x, ef: ErrorFeedback, mesh, axis, tag=None):
    """Error-feedback variant: this rank's quantization residual is carried
    to the next call; the time-average of the outputs is unbiased.

    Single-axis only: the residual models exactly one quantization stage,
    which would understate the error of a nested multi-axis sum."""
    if isinstance(axis, (tuple, list)):
        raise TypeError("compressed_psum_ef supports a single axis; "
                        "compose per-axis calls to keep the residual exact")
    xc = x.to(torch.float32) + ef.residual
    out = compressed_psum(xc, mesh, axis, tag)
    # local residual: what this rank's contribution lost to quantization
    s1 = _shared_scale(xc, mesh, axis, tag)
    deq = torch.clamp(torch.round(xc / s1), -127, 127) * s1
    return out, ErrorFeedback(residual=xc - deq)
