"""Build, binding and launch of the Hopper flash-attention kernels.

Two hand-written forward kernels compute one function, both on the bf16
tensor cores by ``wgmma`` with TMA loads, and the dtype picks the route
(``route``):

* ``wgmma`` (``csrc/flash_attention_wgmma.cu``) takes bfloat16 at every
  head dim: an mbarrier-guarded K/V ring and warp specialisation, with P
  split into two bf16 halves so that P.V keeps f32 accuracy;
* ``wgmma-f32`` (``csrc/flash_attention.cu``) takes float32: every operand
  (q, k, v and P) split into three bf16 pieces, which hold it exactly, each
  product the sum of its six piece products with a + b <= 2, so that the
  result is as exact as the plain version's tolerance asks (TF32, or one
  bf16 rounding, would not be). ``ref.attention_ref(in_pieces=3,
  mid_pieces=3)`` emulates it.

Both replace the TPU kernel
``repro.kernels.flash_attention.flash_attention_pallas``; their sources say
what they compute, what bounds them and how they are laid out. On request
(``return_lse``) each also writes its rows' log-sum-exp, which the third
source, the backward (``csrc/flash_attention_bwd.cu``: dq, dk and dv on the
bf16 tensor cores by ``wgmma`` with TMA loads, both dtypes, routed by
``bwd_route``; ``flash_attention_bwd_cuda``), reads. The reference has no
backward kernel: JAX differentiates its plain path. All three take
the models' layout, q (B, Sq, H, D) and k/v (B, Sk, KV, D), contiguous and
16-byte aligned (TMA reads them; ``ops.tma_operand`` hands them over so), D
in ``HEAD_DIMS``. Head dims 96 and 112 run the 128 layout with the columns
past D zero-filled inside the kernel (``layout_head_dim``): no copy is made
on the host, and the result is the unpadded function. This module builds
them with ``kernels.build`` at first use, checks arguments and launches on
PyTorch's current stream. A kernel
that fails to build or launch raises: there is no fallback from one route
to the other, or to the plain version.

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

__all__ = ["SOURCE", "WGMMA_SOURCE", "BWD_SOURCE", "SOURCES", "ROUTES",
           "BLOCK_Q", "BLOCK_K", "F32_ROWS", "STAGES", "BWD_ROWS",
           "BWD_ROUTES", "HEAD_DIMS", "DTYPES", "route", "bwd_route",
           "layout_head_dim", "f32_block_n", "shared_memory_bytes",
           "bwd_block_n",
           "bwd_shared_memory_bytes",
           "check_args", "check_bwd_args", "flash_attention_cuda",
           "flash_attention_bwd_cuda"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "flash_attention.cu"  # the wgmma-f32 route
WGMMA_SOURCE = _CSRC / "flash_attention_wgmma.cu"  # the wgmma route
BWD_SOURCE = _CSRC / "flash_attention_bwd.cu"  # the gradients, both dtypes
SOURCES = (SOURCE, WGMMA_SOURCE, BWD_SOURCE)
ROUTES = ("wgmma", "wgmma-f32")

BLOCK_Q = 128  # kBQ in both forward sources: two warpgroups of 64 rows
BLOCK_K = 64  # kBK in flash_attention_wgmma.cu: the keys of a ring stage
F32_ROWS = 64  # kRows in flash_attention.cu: a warpgroup's f32 Q tile
STAGES = 2  # kStages: the K/V ring
_WGMMA_EXTRA = 64 + 1024  # barriers, and slack to align the tiles to 1 KB
BWD_ROWS = 64  # kRows in flash_attention_bwd.cu: a block's resident tile
BWD_ROUTES = ("wgmma", "wgmma-f32")  # the backward's, by dtype (bwd_route)
BWD_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # its `dtype`
# head dim -> the layout its instantiation runs (``launch<..., layout, D>``
# in every source's switch): 96 and 112 (phi3-mini, zamba2-7b) run the 128
# layout, whose columns past D the kernels fill with zeros and never store
_LAYOUT = {16: 16, 64: 64, 96: 128, 112: 128, 128: 128, 256: 256}
HEAD_DIMS = tuple(_LAYOUT)
DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1


def route(dtype, D: int) -> str:
    """The kernel a call with this dtype and head dim launches: bfloat16
    takes ``"wgmma"``, float32 ``"wgmma-f32"``."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "wgmma-f32"
    raise ValueError(f"flash_attention: dtype {dtype} is not one of "
                     f"{sorted(map(str, DTYPES))}")


def layout_head_dim(D: int) -> int:
    """The head dim of the layout a call with head dim D runs: 128 for 96
    and 112, D itself otherwise (also for a D that no kernel takes, whose
    layout ``shared_memory_bytes`` still sizes)."""
    return _LAYOUT.get(D, D)


def f32_block_n(D: int) -> int:
    """Keys of a tile that the float32 kernels stage in f32 and split into
    three bf16 pieces (``Cfg::kBN`` of the forward's wgmma-f32 route, and
    of the backward's f32 streamed tiles): 16 in the 256 layout, where
    227 KB hold little beside the f32 resident tiles, and 32 below."""
    return 16 if layout_head_dim(D) == 256 else 32


def shared_memory_bytes(D: int, route: str) -> int:
    """Dynamic shared memory of one block, in the layout of
    ``layout_head_dim(D)``, with the barriers and the alignment slack.
    wgmma: bf16 Q for 128 rows and a ring of K and V stages. wgmma-f32
    (``Cfg::kBytes`` of ``csrc/flash_attention.cu``): f32 Q for 128 rows,
    a staging slot of ``f32_block_n`` f32 keys of K and of V, and the three
    bf16 piece tiles of each."""
    L = layout_head_dim(D)
    if route == "wgmma-f32":
        bn = f32_block_n(D)
        return (2 * F32_ROWS * L * 4 + 2 * bn * L * 4 + 2 * 3 * bn * L * 2
                + _WGMMA_EXTRA)
    if route == "wgmma":
        return 2 * (BLOCK_Q * L + 2 * STAGES * BLOCK_K * L) + _WGMMA_EXTRA
    raise ValueError(f"route must be one of {ROUTES}, got {route!r}")


def bwd_route(dtype, D: int) -> str:
    """The backward's arithmetic for this dtype (one source, both dtypes on
    the bf16 tensor cores): ``"wgmma"`` for bfloat16 (q, k, v, dout as
    they are, P and dS in two bf16 halves), ``"wgmma-f32"`` for float32
    (every operand in three bf16 pieces)."""
    return "wgmma" if route(dtype, D) == "wgmma" else "wgmma-f32"


def bwd_block_n(D: int, dtype) -> int:
    """Rows of a streamed tile in the backward's two large kernels
    (``Cfg::kBN``: the query tile of dkdv, the key tile of dq): 64 for
    bfloat16; for float32, whose resident tiles stay f32 and whose streamed
    tiles are staged in f32 and split into three bf16 pieces, 16 in the
    256 layout and 32 below (its S and dP products stack the pieces along
    N, up to 3 x 32)."""
    if bwd_route(dtype, D) == "wgmma":
        return 64
    return f32_block_n(D)


def bwd_shared_memory_bytes(D: int, dtype) -> int:
    """Dynamic shared memory of one block of either of the backward's two
    large kernels (one layout), in the layout of ``layout_head_dim(D)``
    (``Cfg::kBytes``): the two resident tiles (dkdv: K and V; dq: Q and
    dO; 64 rows, in the input dtype), the ring of streamed tiles (bf16: two
    stages, f32: one staging slot; ``bwd_block_n`` rows of two tiles), for
    f32 the three bf16 piece tiles of each streamed tile, two buffers of
    the 64 x ``bwd_block_n`` f32 values handed between the two warpgroups,
    each stage's lse and Delta (dkdv; f32 also the copy kept once the slot
    is free), 64 bytes of barriers and 1 KB to align the tiles."""
    L, bn = layout_head_dim(D), bwd_block_n(D, dtype)
    f32 = bwd_route(dtype, D) == "wgmma-f32"
    item, ring = (4, 1) if f32 else (2, 2)
    total = (2 * BWD_ROWS * L * item + ring * 2 * bn * L * item
             + (2 * 3 * bn * L * 2 if f32 else 0) + 2 * 4 * BWD_ROWS * bn
             + (2 * ring + (2 if f32 else 0)) * 4 * bn + 64 + 1024)
    return total


def _check_qkv(q, k, v, *, window: int, softcap: float,
               q_offset: int) -> None:
    """The checks every kernel of this module makes on q, k, v and the
    mask's arguments."""
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
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not one of "
                         f"{sorted(map(str, DTYPES))}")
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


def check_args(q, k, v, *, causal: bool = True, window: int = 0,
               softcap: float = 0.0, q_offset: int = 0) -> None:
    """Raise ``ValueError`` on anything the forward kernel does not take."""
    _check_qkv(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    D = q.shape[-1]
    kernel = route(q.dtype, D)
    need = shared_memory_bytes(D, kernel)
    if need > SHARED_MEMORY_BUDGET:
        raise ValueError(f"flash_attention: D={D} on the {kernel} route "
                         f"needs {need} bytes of shared memory, above the "
                         f"{SHARED_MEMORY_BUDGET}-byte budget of one block")
    for name, t in (("q", q), ("k", k), ("v", v)):  # both routes
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s data must be "
                             "16-byte aligned for TMA")


def check_bwd_args(q, k, v, out, lse, dout, *, causal: bool = True,
                   window: int = 0, softcap: float = 0.0,
                   q_offset: int = 0) -> None:
    """Raise ``ValueError`` on anything the backward kernel does not take:
    q, k, v as the forward takes them, out and dout shaped, typed and
    placed as q, lse (B, H, Sq) float32, all contiguous, and q, k, v and
    dout 16-byte aligned (TMA reads them; ``ops.tma_operand`` hands them
    over so)."""
    _check_qkv(q, k, v, window=window, softcap=softcap, q_offset=q_offset)
    B, Sq, H, D = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"{q.dtype} of q's shape {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: lse must be float32 "
                         f"(B={B}, H={H}, Sq={Sq}), got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention backward: {name} must be "
                             "contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} is on "
                             f"{t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention backward: {name}'s data must "
                             "be 16-byte aligned for TMA")
    need = bwd_shared_memory_bytes(D, q.dtype)
    if need > SHARED_MEMORY_BUDGET:
        raise ValueError(f"flash_attention backward: D={D} needs {need} "
                         f"bytes of shared memory, above the "
                         f"{SHARED_MEMORY_BUDGET}-byte budget of one block")


@functools.lru_cache(maxsize=None)
def _entry_points(kernel: str):
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "wgmma":
        lib = kbuild.load(WGMMA_SOURCE)
        fwd, err = (lib.flash_attention_wgmma_fwd,
                    lib.flash_attention_wgmma_error_string)
    else:
        lib = kbuild.load(SOURCE)
        fwd, err = lib.flash_attention_fwd, lib.flash_attention_error_string
    # both: q, k, v, out, lse, B, H, KV, Sq, Sk, D, scale, causal, window,
    # softcap, q_offset, stream
    fwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, ci, ci,
                    cf, ci, vp]
    fwd.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fwd, err


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, q_offset: int = 0,
                         return_lse: bool = False):
    """Launch the kernel of ``route(q.dtype, D)``: q (B, Sq, H, D), k/v
    (B, Sk, KV, D) CUDA tensors -> (B, Sq, H, D) in q's dtype; with
    `return_lse`, (out, lse), lse (B, H, Sq) float32 each row's
    log-sum-exp, as ``ref.attention_ref(return_lse=True)`` gives it (the
    backward's input). Without it the kernel writes no lse.

    Runs on PyTorch's current stream without synchronising. Raises on a
    CPU tensor, on arguments the kernel does not take, and when the build
    or the launch fails.
    """
    check_args(q, k, v, causal=causal, window=window, softcap=softcap,
               q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_cuda needs CUDA tensors, got "
                           f"{q.device}")
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    kernel = route(q.dtype, D)
    out = torch.empty_like(q)
    lse = (torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    fwd, err = _entry_points(kernel)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # the scale as the TPU kernel takes it: 1 / D**0.5 rounded to f32
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, H, KV, Sq, Sk,
                 D, 1.0 / math.sqrt(D), int(bool(causal)), int(window),
                 float(softcap), int(q_offset), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           + err(rc).decode())
    return (out, lse) if return_lse else out


@functools.lru_cache(maxsize=None)
def _bwd_entry_point():
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = kbuild.load(BWD_SOURCE)
    fn, err = lib.flash_attention_bwd, lib.flash_attention_bwd_error_string
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, H, KV, Sq, Sk, D, dtype,
    # scale, causal, window, softcap, q_offset, stream
    fn.argtypes = [vp] * 10 + [ci] * 7 + [cf, ci, ci, cf, ci, vp]
    fn.restype = ci
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p
    return fn, err


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             q_offset: int = 0):
    """Launch the backward kernel: the gradients (dq, dk, dv) of
    ``flash_attention_cuda``'s output for q (B, Sq, H, D) and k, v (B, Sk,
    KV, D), given that output `out`, its `lse` (``return_lse``) and dout
    (B, Sq, H, D), all CUDA tensors; each gradient in its input's dtype
    and shape.

    Computed on the bf16 tensor cores with f32 accumulators from the
    inputs as given and rounded once (``csrc/flash_attention_bwd.cu``;
    ``bwd_route``: bf16 inputs as they are with P and dS in two bf16
    halves, f32 inputs, P and dS in three bf16 pieces each);
    ``ref.attention_grads`` is its plain twin, and its ``in_pieces`` /
    ``mid_pieces`` emulate the splits. Deterministic: no atomics, so two
    launches give bitwise the same gradients. Allocates its outputs and a (B, H, Sq) f32 scratch
    for rowsum(dout * out). Runs on PyTorch's current stream without
    synchronising. Raises on a CPU tensor, on arguments the kernel does
    not take, and when the build or a launch fails.
    """
    check_bwd_args(q, k, v, out, lse, dout, causal=causal, window=window,
                   softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd_cuda needs CUDA tensors, "
                           f"got {q.device}")
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    fn, err = _bwd_entry_point()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq,
                                         dk, dv)),
                B, H, KV, Sq, Sk, D, BWD_DTYPE_CODES[q.dtype],
                1.0 / math.sqrt(D), int(bool(causal)), int(window),
                float(softcap), int(q_offset), stream)
    if rc != 0:
        raise RuntimeError("flash_attention backward kernel launch failed: "
                           + err(rc).decode())
    return dq, dk, dv
