"""Build, binding and launch of the Hopper Mamba-2 SSD-scan kernels.

Two hand-written kernels compute one function, and the dtype picks the
route (``route``); both run every product on the bf16 tensor cores
(``wgmma``), with TMA loads of B and C and warp specialisation:

* ``wgmma`` (``csrc/ssd_scan_wgmma.cu``) takes bfloat16 at every (P, N):
  a TMA ring of x, B and C, with the three f32 operands of its products
  (the weights W, the carried state as C . state reads it, and x_j w_j of
  the state update) each split into two bf16 halves, so that every product
  keeps f32 accuracy;
* ``wgmma-f32`` (``csrc/ssd_scan.cu``) takes float32: every operand of a
  product, the f32 inputs x, B and C too, goes in as three bf16 pieces
  (products of pieces a + b <= 2), each product into a fresh accumulator
  added in f32, so the result keeps f32 accuracy (TF32 would not).

Both replace the TPU kernel ``repro.kernels.ssd_scan.ssd_scan_pallas`` plus
the D skip of its ops wrapper; their sources say what they compute, what
bounds them and how they are laid out. A third, ``csrc/ssd_scan_bwd.cu``,
takes both dtypes and computes the scan's gradients (``ssd_scan_bwd_cuda``) on
the tensor cores (TMA loads, ``wgmma`` products with every f32 operand
split into three bf16 pieces, the group's heads summed inside a block):
the reference has no counterpart, since it differentiates its plain
chunked scan, and the port's training path runs the forward kernel. They take the models' layout,
x (B, S, H, P), dt (B, S, H) and B/C (B, S, G, N), with P in ``HEAD_DIMS``
and N in ``STATE_DIMS``; A and D are float32 (H,). TMA needs x, B and C
contiguous and 16-byte aligned (the ops wrapper makes them so; the f32
kernel reads x with plain loads at its fragments' places, which takes the
same layout). dt is read through its strides by both. The output
is (B, S, H, P), contiguous, in x's dtype. This module builds the kernels
with ``kernels.build`` at first use, checks arguments and launches on
PyTorch's current stream. A kernel that fails to build or launch raises:
there is no fallback from one route to the other.

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

__all__ = ["SOURCE", "WGMMA_SOURCE", "BWD_SOURCE", "SOURCES", "ROUTES",
           "CHUNK", "STAGES", "HEADS_PER_BLOCK", "PIECES", "HEAD_DIMS",
           "STATE_DIMS", "DTYPE_CODES", "route", "shared_memory_bytes",
           "BWD_MID_PIECES", "bwd_in_pieces", "bwd_sums_shape",
           "bwd_shared_memory_bytes",
           "check_args", "check_bwd_args",
           "ssd_scan_cuda", "ssd_scan_bwd_cuda"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "ssd_scan.cu"  # the wgmma-f32 route
WGMMA_SOURCE = _CSRC / "ssd_scan_wgmma.cu"  # the wgmma route
BWD_SOURCE = _CSRC / "ssd_scan_bwd.cu"  # the gradients, both dtypes
SOURCES = (SOURCE, WGMMA_SOURCE, BWD_SOURCE)
ROUTES = ("wgmma", "wgmma-f32")

CHUNK = 64  # kQ in both sources: the kernels' own chunk length
STAGES = 3  # kStages in ssd_scan_wgmma.cu: the x/B/C ring
HEADS_PER_BLOCK = 2  # kHeads in both sources: one consumer warpgroup each
PIECES = 3  # kPieces in ssd_scan.cu: bf16 pieces of an f32 operand
_WGMMA_WARPS = 4 * HEADS_PER_BLOCK  # consumer warps
_WGMMA_EXTRA = 64 + 1024  # barriers, and slack to align the ring to 1 KB
HEAD_DIMS = (16, 32, 64)  # P: the instantiations in both sources
STATE_DIMS = (16, 32, 64, 128)  # N
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # ssd_scan_bwd.cu's
_ALIGN = 1024  # kAlign: every tile starts on the 128-byte swizzle's repeat


def _up(v: int) -> int:
    return -(-v // _ALIGN) * _ALIGN


def route(dtype, P: int, N: int) -> str:
    """The kernel a call with this dtype, head dim and state dim launches:
    bfloat16 takes ``"wgmma"``, float32 ``"wgmma-f32"``."""
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim P={P} is not one of {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan: state dim N={N} is not one of "
                         f"{STATE_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "wgmma-f32"
    raise ValueError(f"ssd_scan: dtype {dtype} is not one of "
                     f"{sorted(map(str, DTYPE_CODES))}")


def shared_memory_bytes(P: int, N: int, route: str = "wgmma-f32") -> int:
    """Dynamic shared memory of one block. wgmma-f32: one staging slot (the
    group's B and C rows in f32 as TMA loads them, and both heads' dt);
    B and C as three bf16 piece tiles each; each head's W as three piece
    tiles; per head 4 x 64 + 4 f32 of step vectors; each head's y_inter
    parked (32 f32 a consumer thread), in C's piece tiles at N = 128 and in
    32 KB of its own below; the barriers and the alignment slack (the tiles
    1 KB aligned; P takes no room). wgmma: a
    ring of stages, each the bf16 x tiles of two heads and the B and C
    tiles of their group; each head's state as two bf16 tiles (hi, lo);
    each stage's f32 dt of both heads; per consumer warp 2 x 64 f32 of
    step weights; the barriers and the alignment slack."""
    if route == "wgmma-f32":
        stage = _up(2 * CHUNK * N * 4 + 4 * HEADS_PER_BLOCK * CHUNK)
        piece = _up(CHUNK * N * 2)
        parked = HEADS_PER_BLOCK * 32 * 128 * 4
        return (stage + 2 * PIECES * piece
                + HEADS_PER_BLOCK * PIECES * _up(CHUNK * CHUNK * 2)
                + 4 * HEADS_PER_BLOCK * (4 * CHUNK + 4)
                + (0 if PIECES * piece >= parked else parked) + 64 + _ALIGN)
    if route == "wgmma":
        stage = 2 * (HEADS_PER_BLOCK * CHUNK * P + 2 * CHUNK * N)
        return (STAGES * stage + HEADS_PER_BLOCK * 2 * 2 * P * N
                + 4 * STAGES * HEADS_PER_BLOCK * CHUNK
                + 4 * _WGMMA_WARPS * 2 * CHUNK + _WGMMA_EXTRA)
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


BWD_MID_PIECES = 3  # kMid in ssd_scan_bwd.cu: pieces of an f32 operand


def bwd_sums_shape(B: int, S: int, G: int, N: int) -> tuple:
    """The f32 scratch of the per-chunk kernel's running sums of dB and dC
    over a group's heads (N = 128 only, where they do not fit the
    registers): per block (b, chunk, group) and consumer warpgroup, 2 n
    tiles x 2 sums x 16 fragment registers x 128 threads."""
    if N != 128:
        raise ValueError(f"ssd_scan_bwd: the sums scratch is for N = 128, "
                         f"got N={N}")
    return (B, -(-S // CHUNK), G, 2, 2, 2, 16, 128)


def bwd_in_pieces(dtype) -> int:
    """bf16 pieces the backward kernel splits an input tile into: 3 hold an
    f32 exactly, a bf16 is its own one (``In<T>`` in the source)."""
    return 3 if dtype == torch.float32 else 1


def bwd_shared_memory_bytes(P: int, N: int, dtype=torch.float32) -> dict:
    """Dynamic shared memory of one block of each of the backward's two
    large kernels (``SweepCfg`` and ``ChunkCfg`` in the source), every
    region 1 KB aligned, plus the barriers and the alignment slack.

    sweep: a two-stage ring, each stage two heads' x or dy rows and the
    group's B or C rows as loaded; the B or C rows as bf16 pieces; the dt
    of both heads a stage; per consumer warp 2 x 64 f32 of scan values.
    chunk: one staging slot (B or C rows, or a head's x and dy rows); B
    and C as pieces (at least 64 columns, zero past N); x and dy as
    pieces; dG^T as three pieces, each two 32-column halves; the f32 dx
    tile (rows padded by 4); the per-step vectors and partial sums."""
    item = torch.tensor([], dtype=dtype).element_size()
    k_in = bwd_in_pieces(dtype)
    nt = max(N, 64)
    sweep = (2 * _up(CHUNK * (2 * P + N) * item) + k_in * _up(CHUNK * N * 2)
             + 4 * 2 * 2 * CHUNK + 4 * 8 * 2 * CHUNK + 64 + _ALIGN)
    chunk = (_up(max(CHUNK * N, 2 * CHUNK * P) * item)
             + 2 * k_in * _up(CHUNK * nt * 2) + 2 * k_in * _up(CHUNK * P * 2)
             + BWD_MID_PIECES * CHUNK * 64 * 2 + 4 * CHUNK * (P + 4)
             + 4 * (23 * CHUNK + 16) + 64 + _ALIGN)
    return {"sweep": sweep, "chunk": chunk}


def _check_common(x, dt, A, Bm, Cm, D) -> None:
    """The checks the forward and the backward kernels share."""
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


def check_args(x, dt, A, Bm, Cm, D=None) -> None:
    """Raise ``ValueError`` on anything the kernel does not take."""
    _check_common(x, dt, A, Bm, Cm, D)
    B, S, H, P = x.shape
    N = Bm.shape[3]
    kernel = route(x.dtype, P, N)
    need = shared_memory_bytes(P, N, kernel)
    if need > SHARED_MEMORY_BUDGET:
        raise ValueError(f"ssd_scan: P={P}, N={N} on the {kernel} route "
                         f"need {need} bytes of shared memory, above the "
                         f"{SHARED_MEMORY_BUDGET}-byte budget of one block")
    if S > 2 ** 31 - 1 - CHUNK:
        raise ValueError(f"ssd_scan: S={S} does not fit a TMA coordinate")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous on the "
                             f"{kernel} route (TMA reads it)")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name}'s data must be 16-byte "
                             "aligned for TMA")


def check_bwd_args(x, dt, A, Bm, Cm, D, dy) -> None:
    """Raise ``ValueError`` on anything the backward kernel does not take.
    It reads x, B, C and dy with TMA (contiguous, 16-byte aligned data;
    ``ops.ssd_scan_bwd`` hands them over so) and dt through its strides,
    in either dtype."""
    _check_common(x, dt, A, Bm, Cm, D)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"ssd_scan_bwd: dy must be {tuple(x.shape)} "
                         f"{x.dtype} like x, got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    if dy.stride(-1) != 1:
        raise ValueError("ssd_scan_bwd: the last axis of dy must be "
                         "contiguous")
    if dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy is on {dy.device}, x on "
                         f"{x.device}")
    S, G, P, N = x.shape[1], Bm.shape[2], x.shape[3], Bm.shape[3]
    if S > 2 ** 31 - 1 - CHUNK:
        raise ValueError(f"ssd_scan_bwd: S={S} does not fit a TMA "
                         "coordinate")
    if G > 65535:
        raise ValueError(f"ssd_scan_bwd: G={G} is above 65535 (a grid "
                         "dimension)")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan_bwd: {name} must be contiguous "
                             "(TMA reads it)")
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan_bwd: {name}'s data must be 16-byte "
                             "aligned for TMA")
    need = bwd_shared_memory_bytes(P, N, x.dtype)
    if max(need.values()) > SHARED_MEMORY_BUDGET:
        raise ValueError(f"ssd_scan_bwd: P={P}, N={N} need {need} bytes of "
                         f"shared memory, above the {SHARED_MEMORY_BUDGET}-"
                         "byte budget of one block")


@functools.lru_cache(maxsize=None)
def _entry_points(kernel: str):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if kernel == "wgmma":
        lib = kbuild.load(WGMMA_SOURCE)
        fwd, err = lib.ssd_scan_wgmma_fwd, lib.ssd_scan_wgmma_error_string
    else:
        lib = kbuild.load(SOURCE)
        fwd, err = lib.ssd_scan_fwd, lib.ssd_scan_error_string
    # x, dt, A, Bm, Cm, D, out, B, S, H, G, P, N, dt strides, stream
    fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp]
    fwd.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fwd, err


def ssd_scan_cuda(x, dt, A, Bm, Cm, D=None):
    """Launch the kernel of ``route(x.dtype, P, N)``: x (B,S,H,P),
    dt (B,S,H), A (H,), Bm/Cm (B,S,G,N), D (H,) or None, CUDA tensors ->
    y (B,S,H,P) in x's dtype.

    Runs on PyTorch's current stream without synchronising. Raises on a
    CPU tensor, on arguments the kernel does not take, and when the build
    or the launch fails.
    """
    check_args(x, dt, A, Bm, Cm, D)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan_cuda needs CUDA tensors, got "
                           f"{x.device}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    kernel = route(x.dtype, P, N)
    out = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    fwd, err = _entry_points(kernel)
    pointers = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), None if D is None else D.data_ptr(),
                out.data_ptr())
    strides = (ctypes.c_longlong * 3)(*dt.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fwd(*pointers, B, S, H, G, P, N,
                 ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan {kernel} kernel launch failed: "
                           + err(rc).decode())
    return out


@functools.lru_cache(maxsize=None)
def _bwd_entry_point():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = kbuild.load(BWD_SOURCE)
    fn, err = lib.ssd_scan_bwd, lib.ssd_scan_bwd_error_string
    # x, dt, A, Bm, Cm, D, dy; dx, ddt, dA, dB, dC, dD; states, dstates,
    # dA_part, dD_part, sums; B, S, H, G, P, N, dtype; dt strides, stream
    fn.argtypes = [vp] * 18 + [ci] * 7 + [vp, vp]
    fn.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fn, err


def ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy):
    """Launch the backward kernel: the gradients of ``ssd_scan_cuda``'s
    y (B,S,H,P) for its inputs x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm
    (B,S,G,N), D (H,) or None, given dy (B,S,H,P), all CUDA tensors ->
    (dx, ddt, dA, dBm, dCm, dD): dx, ddt, dBm and dCm contiguous in x's
    dtype, dA and dD (H,) float32, dD None when D is.

    Computed to f32 accuracy from the inputs as read (x, B, C and dy
    contiguous and 16-byte aligned, dt through its strides) and rounded
    once. Deterministic: two launches give bitwise the same gradients.
    Allocates its outputs and an f32 scratch: the state entering and the
    gradient of the state leaving each 64-step chunk, 2 x (B, H,
    ceil(S/64), P, N), 2 x (B, ceil(S/64), H) partials of dA and dD, and
    at N = 128 the dB and dC sums over a group's heads
    (``bwd_sums_shape``: per block, where they do not fit the registers;
    no per-head partial).
    Runs on PyTorch's current stream without synchronising. Raises on a
    CPU tensor, on arguments the kernel does not take, and when the build
    or the launch fails.
    """
    check_bwd_args(x, dt, A, Bm, Cm, D, dy)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd_scan_bwd_cuda needs CUDA tensors, got "
                           f"{x.device}")
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    NC = -(-S // CHUNK)
    f32 = torch.float32

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=x.device)

    dx, ddt = empty(B, S, H, P, dtype=x.dtype), empty(B, S, H, dtype=x.dtype)
    dB, dC = empty(B, S, G, N, dtype=x.dtype), empty(B, S, G, N, dtype=x.dtype)
    dA, dD = empty(H), (None if D is None else empty(H))
    states, dstates = empty(B, H, NC, P, N), empty(B, H, NC, P, N)
    dA_part, dD_part = empty(B, NC, H), empty(B, NC, H)
    sums = empty(*bwd_sums_shape(B, S, G, N)) if N == 128 else None
    fn, err = _bwd_entry_point()
    pointers = [t.data_ptr() if t is not None else None for t in (
        x, dt, A, Bm, Cm, D, dy, dx, ddt, dA, dB, dC, dD, states, dstates,
        dA_part, dD_part, sums)]
    strides = (ctypes.c_longlong * 3)(*dt.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*pointers, B, S, H, G, P, N, DTYPE_CODES[x.dtype],
                ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError("ssd_scan backward kernel launch failed: "
                           + err(rc).decode())
    return dx, ddt, dA, dB, dC, dD
