"""Dispatching wrappers for the port's kernels.

Counterpart of ``repro.kernels.ops``. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor takes the plain PyTorch version
in ``ref``. There is no fallback from a failed launch, and no 128-lane
padding: that is a TPU rule, and the CUDA kernel masks its own tail.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.sodda_inner import sodda_inner_cuda
from repro_torch.kernels.ssd_scan import route as ssd_route
from repro_torch.kernels.ssd_scan import CHUNK as SSD_CHUNK
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda

FORCES = ("auto", "cuda", "ref")
TMA_ALIGNMENT = 16  # bytes: where a TMA operand's data must start


def tma_operand(t):
    """`t` as TMA reads it, contiguous and 16-byte aligned: `t` itself where
    it already is, else a copy (a strided view, or a contiguous view that
    starts inside an element group, such as ``buf[1:1 + n].view(...)``)."""
    t = t.contiguous()
    return t if t.data_ptr() % TMA_ALIGNMENT == 0 else t.clone()


def sodda_inner(w0, Xl, yl, mu, gamma, loss: str = "hinge",
                force: str = "auto"):
    """Batched SODDA inner loop. w0 (B,mt), Xl (B,L,mt), yl (B,L), mu (B,mt).

    ``force="auto"`` launches the CUDA kernel for CUDA tensors and runs
    :func:`ref.sodda_inner_ref` for CPU tensors; ``"cuda"`` requires CUDA
    tensors; ``"ref"`` runs the plain version on any device.
    ``sodda_inner.launches`` counts kernel launches.
    """
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    device = Xl.device.type
    if force == "ref" or (force == "auto" and device == "cpu"):
        return ref.sodda_inner_ref(w0, Xl, yl, mu, gamma, loss)
    if device != "cuda":
        raise RuntimeError(f"sodda_inner(force={force!r}) launches the CUDA "
                           f"kernel and needs CUDA tensors, got {Xl.device}")
    out = sodda_inner_cuda(w0, Xl, yl, mu, gamma, loss)
    sodda_inner.launches += 1
    return out


sodda_inner.launches = 0


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    force: str = "auto"):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) -> (B,Sq,H,D) (layout as models use it).

    ``force="auto"`` launches the CUDA kernel for CUDA tensors and runs
    :func:`ref.attention_ref` for CPU tensors; ``"cuda"`` requires CUDA
    tensors; ``"ref"`` runs the plain version on any device. Inputs are
    made contiguous and 16-byte aligned (both routes read them with TMA),
    with a copy only where they are not (:func:`tma_operand`); nothing is
    padded.
    A kernel call in grad mode whose q, k or v requires grad goes through a
    ``torch.autograd.Function`` (``_FlashAttention``): the forward kernel
    also writes its rows' log-sum-exp, and the backward is the backward
    kernel (:func:`flash_attention_bwd`); any other kernel call writes no
    log-sum-exp. The plain version is differentiated by autograd.
    ``flash_attention.launches`` counts forward kernel launches.
    """
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    device = q.device.type
    if force == "ref" or (force == "auto" and device == "cpu"):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset)
    if device != "cuda":
        raise RuntimeError(f"flash_attention(force={force!r}) launches the "
                           f"CUDA kernel and needs CUDA tensors, got "
                           f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                     q_offset)
    out = flash_attention_cuda(*_flash_operands(q, k, v), causal=causal,
                               window=window, softcap=softcap,
                               q_offset=q_offset)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _flash_operands(q, k, v):
    """q, k, v as the forward kernels read them (TMA, on both routes)."""
    return tma_operand(q), tma_operand(k), tma_operand(v)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        q, k, v = _flash_operands(q, k, v)
        opts = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset)
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **opts)
        flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = flash_attention_bwd(*ctx.saved_tensors, dout.contiguous(),
                                    **ctx.opts)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,) * 4


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        q_offset: int = 0, force: str = "auto"):
    """The gradients (dq, dk, dv) of ``flash_attention``'s output for q
    (B,Sq,H,D) and k, v (B,Sk,KV,D), given that output `out`, its rows'
    log-sum-exp `lse` (B,H,Sq) f32 and dout (B,Sq,H,D); each gradient in
    its input's dtype.

    ``force="auto"`` launches the backward kernel
    (``kernels.flash_attention.flash_attention_bwd_cuda``) for CUDA tensors
    and runs :func:`ref.attention_grads` for CPU tensors; ``"cuda"``
    requires CUDA tensors; ``"ref"`` runs the plain version on any device.
    The kernel reads q, k, v and dout with TMA, so q, k, v, out, dout and
    lse are made contiguous and 16-byte aligned first (a copy only where
    they are not: :func:`tma_operand`).
    ``flash_attention_bwd.launches`` counts kernel launches.
    """
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)
    device = q.device.type
    if force == "ref" or (force == "auto" and device == "cpu"):
        return ref.attention_grads(q, k, v, out, lse, dout, **opts)
    if device != "cuda":
        raise RuntimeError(f"flash_attention_bwd(force={force!r}) launches "
                           f"the CUDA kernel and needs CUDA tensors, got "
                           f"{q.device}")
    grads = flash_attention_bwd_cuda(*map(tma_operand,
                                          (q, k, v, out, lse, dout)), **opts)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0


def ssd_scan(x, dt, A, Bm, Cm, D=None, chunk: int = 128, force: str = "auto"):
    """x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N) -> y (B,S,H,P).

    The Mamba-2 SSD scan plus D . x, rounded once to x's dtype.
    ``force="auto"`` launches the CUDA kernel of
    ``kernels.ssd_scan.route(dtype, P, N)`` for CUDA tensors (bf16: the
    wgmma kernel; f32: the wgmma-f32 kernel) and runs
    :func:`ref.ssd_chunked_ref` with chunk length `chunk` for CPU tensors;
    ``"cuda"`` requires CUDA tensors; ``"ref"`` runs the plain version on
    any device. The kernels use their own chunk (``ssd_scan.CHUNK``); the
    result depends on the chunk only through f32 rounding. A and D are
    taken in float32; nothing is padded. Both routes read B and C with TMA
    (and x with TMA or at their fragments' places), so x, B and C are made
    contiguous and 16-byte aligned first (a copy only where they are not:
    :func:`tma_operand`).

    A kernel launch goes through a ``torch.autograd.Function`` whose
    backward is the backward kernel (:func:`ssd_scan_bwd`) on the operands
    the forward kernel read; the plain version is differentiated by
    autograd.
    ``ssd_scan.launches`` counts kernel launches, ``ssd_scan.route_launches``
    the same launches by route.
    """
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    device = x.device.type
    if force == "ref" or (force == "auto" and device == "cpu"):
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    if device != "cuda":
        raise RuntimeError(f"ssd_scan(force={force!r}) launches the CUDA "
                           f"kernel and needs CUDA tensors, got {x.device}")
    f32 = torch.float32
    return _SsdScan.apply(x, dt, A.to(f32).contiguous(), Bm, Cm,
                          None if D is None else D.to(f32).contiguous())


ssd_scan.launches = 0
ssd_scan.route_launches = {"wgmma": 0, "wgmma-f32": 0}


class _SsdScan(torch.autograd.Function):
    """The forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D):
        kernel = ssd_route(x.dtype, x.shape[-1], Bm.shape[-1])
        x, Bm, Cm = tma_operand(x), tma_operand(Bm), tma_operand(Cm)
        out = ssd_scan_cuda(x, dt, A, Bm, Cm, D)
        ssd_scan.launches += 1
        ssd_scan.route_launches[kernel] += 1
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        return out

    @staticmethod
    def backward(ctx, dy):
        return ssd_scan_bwd(*ctx.saved_tensors, dy.contiguous())


def ssd_scan_bwd(x, dt, A, Bm, Cm, D, dy, force: str = "auto"):
    """The gradients of ``ssd_scan``'s y for its inputs, given dy
    (B,S,H,P): (dx, ddt, dA, dBm, dCm, dD), dx, ddt, dBm and dCm in x's
    dtype, dA and dD float32, dD None when D is.

    ``force="auto"`` launches the backward kernel
    (``kernels.ssd_scan.ssd_scan_bwd_cuda``) for CUDA tensors and runs
    :func:`ref.ssd_chunked_grads` (autograd through the plain chunked
    version at the kernel's chunk length) for CPU tensors; ``"cuda"``
    requires CUDA tensors; ``"ref"`` runs the plain version on any device.
    A and D are taken in float32; the kernel reads x, B, C and dy with
    TMA, so they are made contiguous and 16-byte aligned first (a copy
    only where they are not: :func:`tma_operand`). ``ssd_scan_bwd.launches``
    counts kernel launches.
    """
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    device = x.device.type
    if force == "ref" or (force == "auto" and device == "cpu"):
        return ref.ssd_chunked_grads(x, dt, A, Bm, Cm, D, dy,
                                     chunk=SSD_CHUNK)
    if device != "cuda":
        raise RuntimeError(f"ssd_scan_bwd(force={force!r}) launches the "
                           f"CUDA kernel and needs CUDA tensors, got "
                           f"{x.device}")
    f32 = torch.float32
    out = ssd_scan_bwd_cuda(tma_operand(x), dt, A.to(f32).contiguous(),
                            tma_operand(Bm), tma_operand(Cm),
                            None if D is None else D.to(f32).contiguous(),
                            tma_operand(dy))
    ssd_scan_bwd.launches += 1
    return out


ssd_scan_bwd.launches = 0
