"""Build, binding and launch of the Hopper Mamba-2 SSD-scan kernel.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas`` plus the D skip of its ops
wrapper; its source says what it computes, what bounds it and how it is
laid out. It takes the models' layout, x (B, S, H, P), dt (B, S, H) and
B/C (B, S, G, N), read through their strides (the last axis of x, B and C
contiguous), float32 or bfloat16, with P in ``HEAD_DIMS`` and N in
``STATE_DIMS``; A and D are float32 (H,). The output is (B, S, H, P),
contiguous, in x's dtype. This module builds it with ``kernels.build`` at
first use, checks arguments and launches it on PyTorch's current stream.

Nothing here runs at import: the CPU tests import this module on hosts
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels.build import SHARED_MEMORY_BUDGET

__all__ = ["SOURCE", "CHUNK", "HEAD_DIMS", "STATE_DIMS", "DTYPE_CODES",
           "shared_memory_bytes", "check_args", "ssd_scan_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

CHUNK = 64  # kQ in the source: the kernel's own chunk length
PAD = 4  # kPad
HEAD_DIMS = (16, 32, 64)  # P: the instantiations in the source
STATE_DIMS = (16, 32, 64, 128)  # N
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def shared_memory_bytes(P: int, N: int) -> int:
    """Dynamic shared memory of one block: the B and C tiles and the state
    (rows padded by 4), the x tile, W (rows padded by 4) and 4 x 64 + 4
    per-step scalars, all f32."""
    return 4 * (2 * CHUNK * (N + PAD) + CHUNK * P + CHUNK * (CHUNK + PAD)
                + P * (N + PAD) + 4 * CHUNK + 4)


def check_args(x, dt, A, Bm, Cm, D=None) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError(f"ssd_scan: x, dt, Bm, Cm must be 4-D, 3-D, 4-D, "
                         f"4-D, got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (tuple(dt.shape) != (B, S, H) or tuple(Bm.shape) != (B, S, G, N)
            or tuple(Cm.shape) != tuple(Bm.shape)):
        raise ValueError(f"ssd_scan: for x {tuple(x.shape)} dt must be "
                         f"(B={B}, S={S}, H={H}) and Bm, Cm both (B, S, G, N)"
                         f", got {tuple(dt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if min(B, S, H, G) == 0:
        raise ValueError("ssd_scan: an empty tensor launches no kernel")
    if H % G:
        raise ValueError(f"ssd_scan: H={H} is not a multiple of G={G}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim P={P} is not one of {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: state dim N={N} is not one of "
                         f"{STATE_DIMS}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan: dtype {x.dtype} is not one of "
                         f"{sorted(map(str, DTYPE_CODES))}")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: {name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: the last axis of {name} must be "
                             "contiguous")
    for name, t in (("A", A), ("D", D)):
        if t is None:
            continue
        if tuple(t.shape) != (H,) or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be a contiguous float32 "
                             f"(H={H},) tensor, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D)):
        if t is not None and t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
    if B > 65535:
        raise ValueError(f"ssd_scan: B={B} is above 65535 (a grid dimension)")
    need = shared_memory_bytes(P, N)
    if need > SHARED_MEMORY_BUDGET:
        raise ValueError(f"ssd_scan: P={P}, N={N} need {need} bytes of "
                         f"shared memory, above the {SHARED_MEMORY_BUDGET}-"
                         "byte budget of one block")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                 ci, ci, ci, vp, vp]
    lib.ssd_scan_fwd.restype = ci
    lib.ssd_scan_error_string.argtypes = [ci]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_cuda(x, dt, A, Bm, Cm, D=None):
    """Launch the kernel: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N),
    D (H,) or None, CUDA tensors -> y (B,S,H,P) in x's dtype.

    Runs on PyTorch's current stream without synchronising. Raises on a
    CPU tensor, on arguments the kernel does not take, and when the launch
    is refused.
    """
    check_args(x, dt, A, Bm, Cm, D)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan_cuda needs CUDA tensors, got "
                           f"{x.device}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    out = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(),
                                        *Bm.stride()[:3], *Cm.stride()[:3])
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if D is None else D.data_ptr(),
            out.data_ptr(), B, S, H, G, P, N, DTYPE_CODES[x.dtype],
            ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           + lib.ssd_scan_error_string(rc).decode())
    return out
