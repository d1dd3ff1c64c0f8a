"""Build, binding and launch of the Hopper ``sodda_inner`` kernel.

The kernel (``csrc/sodda_inner.cu``) replaces the TPU kernel
``repro.kernels.sodda_inner.sodda_inner_pallas``; its source says what it
computes, what bounds it and how it is laid out. This module compiles it at
first use with ``nvcc`` into a shared library with a plain C interface
(``kernels.build``: under ``build/torch_kernels/``, rebuilt when the source
changes), loads it with ctypes, checks arguments and launches it on
PyTorch's current stream.

Nothing here runs at import: the CPU tests import this module on hosts
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as kbuild

__all__ = ["SOURCE", "SHARED_MEMORY_BUDGET", "LOSS_CODES", "BUCKETS",
           "MU_BUCKET", "MAX_SLOTS", "SLOT_EXTRA", "pitch", "bucket",
           "shared_rows", "ring_slots", "shared_memory_bytes", "row_copy",
           "check_args", "sodda_inner_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sodda_inner.cu"

# The source's layout (kMaxSlots, kSlotExtra, kMuBucket and bucket_of
# there): one block of four warps per chain (the chain, the producer, two
# d0 helpers) and a ring of row slots in shared memory.
SHARED_MEMORY_BUDGET = kbuild.SHARED_MEMORY_BUDGET
LOSS_CODES = {"hinge": 0, "logistic": 1, "squared": 2}
BUCKETS = (4, 8, 12, 16)  # float4 groups a chain lane holds in registers
MU_BUCKET = 12  # mu in registers up to this bucket, in shared memory above
MAX_SLOTS = 8
SLOT_EXTRA = 32  # bytes a slot: three mbarriers and (d0_i, y_i)


def pitch(mt: int) -> int:
    """Floats a row takes in the ring: mt rounded up to a multiple of 4."""
    return (mt + 3) // 4 * 4


def bucket(mt: int) -> int:
    """The column bucket the launch instantiates: the float4 groups each
    lane of the chain warp holds wbar in (mt <= 128 * bucket), or 0 above
    the largest bucket, where wbar lives in shared memory."""
    groups = -(-mt // 128)
    return next((g for g in BUCKETS if groups <= g), 0)


def shared_rows(mt: int) -> int:
    """Rows of mt floats beside the ring: mu above ``MU_BUCKET`` (the
    largest bucket and 0), and wbar at 0."""
    g = bucket(mt)
    return 2 if g == 0 else int(g > MU_BUCKET)


def _fixed_bytes(mt: int) -> int:
    return shared_rows(mt) * 4 * pitch(mt)


def ring_slots(L: int, mt: int) -> int:
    """Row slots in the ring: as many as the budget holds, at most
    ``MAX_SLOTS`` and at most max(L, 1), rounded down to an even number
    above 1 (each d0 helper takes the slots of one parity); 0 where not
    even one fits."""
    fit = max(0, SHARED_MEMORY_BUDGET - _fixed_bytes(mt)) // (
        4 * pitch(mt) + SLOT_EXTRA)
    slots = min(fit, max(L, 1), MAX_SLOTS)
    return slots - slots % 2 if slots > 1 else slots


def shared_memory_bytes(L: int, mt: int) -> int:
    """Dynamic shared memory of one block: the ring (a padded row and
    ``SLOT_EXTRA`` bytes a slot) and the ``shared_rows`` rows of mu and
    wbar. Where not even one slot fits, what one slot would need."""
    slots = max(ring_slots(L, mt), 1)
    return _fixed_bytes(mt) + slots * (4 * pitch(mt) + SLOT_EXTRA)


def row_copy(mt: int, data_ptr: int) -> str:
    """How the producer copies a row of X: ``"bulk"`` (TMA's cp.async.bulk)
    where the row pitch is a multiple of 16 bytes and X is 16-byte
    aligned, else ``"cp.async"`` (4 bytes a lane)."""
    return "bulk" if mt % 4 == 0 and data_ptr % 16 == 0 else "cp.async"


def check_args(w0, Xl, yl, mu, loss: str) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    if loss not in LOSS_CODES:
        raise ValueError(f"sodda_inner: unknown loss {loss!r}; "
                         f"expected one of {sorted(LOSS_CODES)}")
    if Xl.dim() != 3:
        raise ValueError(f"sodda_inner: Xl must be (B, L, mt), got "
                         f"{tuple(Xl.shape)}")
    B, L, mt = Xl.shape
    if B == 0:
        raise ValueError("sodda_inner: an empty batch (B = 0) launches no "
                         "kernel")
    want = {"w0": (B, mt), "yl": (B, L), "mu": (B, mt)}
    for name, t in (("w0", w0), ("yl", yl), ("mu", mu)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"sodda_inner: {name} must be {want[name]} for "
                             f"Xl {tuple(Xl.shape)}, got {tuple(t.shape)}")
    for name, t in (("w0", w0), ("Xl", Xl), ("yl", yl), ("mu", mu)):
        if t.dtype != torch.float32:
            raise ValueError(f"sodda_inner: {name} must be float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sodda_inner: {name} must be contiguous")
        if t.device != Xl.device:
            raise ValueError(f"sodda_inner: {name} is on {t.device}, Xl on "
                             f"{Xl.device}")
    if ring_slots(L, mt) < 1:
        raise ValueError(
            f"sodda_inner: mt={mt}, L={L} needs {shared_memory_bytes(L, mt)} "
            f"bytes of shared memory, above the {SHARED_MEMORY_BUDGET}-byte "
            "budget of one block")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = kbuild.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sodda_inner_f32.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp,
                                    ci, ci, ci, ci, vp]
    lib.sodda_inner_f32.restype = ci
    lib.sodda_inner_error_string.argtypes = [ci]
    lib.sodda_inner_error_string.restype = ctypes.c_char_p
    return lib


def sodda_inner_cuda(w0, Xl, yl, mu, gamma, loss: str = "hinge"):
    """Launch the kernel: w0 (B, mt), Xl (B, L, mt), yl (B, L), mu (B, mt),
    all float32 CUDA tensors, gamma a host number -> (B, mt).

    Runs on PyTorch's current stream without synchronising. Raises on a
    CPU tensor, on arguments the kernel does not take, and when the launch
    is refused.
    """
    check_args(w0, Xl, yl, mu, loss)
    if Xl.device.type != "cuda":
        raise RuntimeError(f"sodda_inner_cuda needs CUDA tensors, got "
                           f"{Xl.device}")
    if isinstance(gamma, torch.Tensor):
        raise TypeError("sodda_inner_cuda: pass gamma as a host number; "
                        "reading a tensor would synchronise")
    B, L, mt = Xl.shape
    out = torch.empty_like(w0)
    lib = _library()
    with torch.cuda.device(Xl.device):
        stream = torch.cuda.current_stream(Xl.device).cuda_stream
        rc = lib.sodda_inner_f32(w0.data_ptr(), Xl.data_ptr(), yl.data_ptr(),
                                 mu.data_ptr(), float(gamma), out.data_ptr(),
                                 B, L, mt, LOSS_CODES[loss], stream)
    if rc != 0:
        raise RuntimeError("sodda_inner kernel launch failed: "
                           + lib.sodda_inner_error_string(rc).decode())
    return out
