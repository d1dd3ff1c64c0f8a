"""Build, binding and launch of the Hopper flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; its source says
what it computes, what bounds it and how it is laid out. It takes the
models' layout, q (B, Sq, H, D) and k/v (B, Sk, KV, D), contiguous, float32
or bfloat16, D in ``HEAD_DIMS``. This module builds it with ``kernels.build``
at first use, checks arguments and launches it on PyTorch's current stream.

Nothing here runs at import: the CPU tests import this module on hosts
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.build import SHARED_MEMORY_BUDGET

__all__ = ["SOURCE", "BLOCK_Q", "BLOCK_K", "HEAD_DIMS", "DTYPE_CODES",
           "shared_memory_bytes", "check_args", "flash_attention_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

BLOCK_Q = BLOCK_K = 64  # kBQ, kBK in the source
PAD = 4  # kPad
HEAD_DIMS = (16, 64, 128, 256)  # the instantiations in the source
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def shared_memory_bytes(D: int) -> int:
    """Dynamic shared memory of one block: f32 Q and K tiles (rows padded
    by 4), the V tile and the P tile."""
    return 4 * (BLOCK_Q * (D + PAD) + BLOCK_K * (D + PAD) + BLOCK_K * D
                + BLOCK_Q * (BLOCK_K + PAD))


def check_args(q, k, v, *, causal: bool = True, window: int = 0,
               softcap: float = 0.0, q_offset: int = 0) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    if tuple(k.shape) != (B, Sk, KV, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: for q {tuple(q.shape)} k and v "
                         f"must both be (B={B}, Sk, KV, D={D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if min(B, Sq, H, Sk, KV) == 0:
        raise ValueError("flash_attention: an empty tensor launches no "
                         "kernel")
    if H % KV:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not one of "
                         f"{sorted(map(str, DTYPE_CODES))}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    if window < 0 or q_offset < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window={window}, "
                         f"q_offset={q_offset} and softcap={softcap} must "
                         "be >= 0")
    if max(H, B) > 65535 or q_offset + Sq > _INT_MAX or Sk > _INT_MAX:
        raise ValueError("flash_attention: H and B must be <= 65535 (grid "
                         "dimensions) and positions must fit int32")
    need = shared_memory_bytes(D)
    if need > SHARED_MEMORY_BUDGET:
        raise ValueError(f"flash_attention: D={D} needs {need} bytes of "
                         f"shared memory, above the {SHARED_MEMORY_BUDGET}-"
                         "byte budget of one block")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SOURCE)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                        ci, ci, cf, ci, ci, cf, ci, vp]
    lib.flash_attention_fwd.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0):
    """Launch the kernel: q (B, Sq, H, D), k/v (B, Sk, KV, D) CUDA tensors
    -> (B, Sq, H, D) in q's dtype.

    Runs on PyTorch's current stream without synchronising. Raises on a
    CPU tensor, on arguments the kernel does not take, and when the launch
    is refused.
    """
    check_args(q, k, v, causal=causal, window=window, softcap=softcap,
               q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_cuda needs CUDA tensors, got "
                           f"{q.device}")
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the scale as the TPU kernel takes it: 1 / D**0.5 rounded to f32
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KV, Sq, Sk, D, DTYPE_CODES[q.dtype], 1.0 / math.sqrt(D),
            int(bool(causal)), int(window), float(softcap), int(q_offset),
            stream)
    if rc != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    return out
