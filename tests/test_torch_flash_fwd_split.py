"""The flash forward kernel's float32 tensor-core arithmetic, on the CPU.

``csrc/flash_attention.cu`` (the ``wgmma-f32`` route) forms both products
of float32 attention on the bf16 tensor cores: q, k, v and P each as three
bf16 pieces, which hold an f32 value exactly, every product the sum of its
six piece products with a + b <= 2. ``ref.attention_ref(in_pieces=,
mid_pieces=)`` writes that arithmetic out in PyTorch. Here, at small shapes
(S = 70: no multiple of any tile), every head dim and every mask:

* the kernel's emulation (3, 3) is within 2e-6 of max|v| of an f64
  attention and of the JAX package's ``attention_ref`` on the same numpy
  inputs, and its lse within 1e-6 of the f64 lse;
* the split control (1, 1), every operand rounded once to bf16 as a
  textbook tensor-core kernel takes f32 inputs, misses the f32 route's
  tolerance (``chip_smoke.py``'s FLASH_F32_TOL, rtol = atol = 2e-5) on
  every case;
* the defaults are bitwise the function before the options existed, and
  the options are refused outside their range or beside ``p_split``.

Also the source includes the shared header and has left the CUDA cores.
"""
import math
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ref

F64_TOL = 2e-6  # the emulation's gap to f64, over max|v|
LSE_TOL = 1e-6  # its lse's, absolute
FLASH_F32_TOL = 2e-5  # the f32 route's rule on the card: rtol = atol
S = 70  # unaligned: no multiple of any tile
# (id, options, group, extra keys past Sq)
MASKS = [("causal", dict(causal=True), 1, 0),
         ("noncausal_gqa2", dict(causal=False), 2, 0),
         ("window24_softcap50_gqa4", dict(causal=True, window=24,
                                          softcap=50.0), 4, 0),
         ("offset7", dict(causal=True, q_offset=7), 2, 7),
         ("noncausal_window20_softcap50",
          dict(causal=False, window=20, softcap=50.0), 1, 0)]
MASK_IDS = [m[0] for m in MASKS]
F32_ROUTE = dict(in_pieces=3, mid_pieces=3)
SPLIT_CONTROL = dict(in_pieces=1, mid_pieces=1)


@pytest.fixture(scope="module")
def J():
    """The JAX package's reference, imported by the tests that use it."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jax_ref)


def _inputs(D, group, extra=0, H=4, Sq=S, seed=2):
    """q (1,Sq,H,D), k/v (1,Sq+extra,H/group,D) as numpy f32, unit
    variance (the scores' std is 1, so the softcap and the softmax both
    bite)."""
    rng = np.random.default_rng(seed + D + 10 * group + extra)
    KV, Sk = H // group, Sq + extra
    return [rng.normal(size=shape).astype(np.float32) for shape in (
        (1, Sq, H, D), (1, Sk, KV, D), (1, Sk, KV, D))]


def _port(args, **opts):
    """ref.attention_ref on the inputs: (out, lse)."""
    q, k, v = (torch.from_numpy(a) for a in args)
    return ref.attention_ref(q, k, v, return_lse=True, **opts)


def _f64(args, **opts):
    """The attention and each row's log-sum-exp in f64, (out, lse)."""
    q, k, v = (torch.from_numpy(a).double() for a in args)
    out = ref.attention_naive(q, k, v, **opts)
    Sq, H, D = q.shape[1:]
    group = H // k.shape[2]
    kh = k.repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kh) / math.sqrt(D)
    softcap = opts.get("softcap", 0.0)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = opts.get("q_offset", 0) + torch.arange(Sq)
    kpos = torch.arange(k.shape[1])
    mask = torch.ones(Sq, k.shape[1], dtype=torch.bool)
    if opts.get("causal", True):
        mask &= kpos[None] <= qpos[:, None]
    if opts.get("window", 0) > 0:
        mask &= qpos[:, None] - kpos[None] < opts["window"]
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return out, lse


def _gap(got, want, v):
    """max |got - want| over max|v|."""
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want)).max()
                 / np.abs(v).max())


def _misses(got, want, tol=FLASH_F32_TOL):
    """Whether `got` fails ``assert_close(got, want, rtol=tol, atol=tol)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool((np.abs(got - want) > tol + tol * np.abs(want)).any())


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_f32_pieces_hold_the_f64_attention_and_jax(J, D, mask):
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    got, _ = _port(args, **F32_ROUTE, **opts)
    want, _ = _f64(args, **opts)
    assert _gap(got.numpy(), want.numpy(), args[2]) <= F64_TOL
    jax_out = np.asarray(J.ref.attention_ref(
        *(J.jnp.asarray(a) for a in args), **opts))
    assert np.isfinite(jax_out).all()
    assert _gap(got.numpy(), jax_out, args[2]) <= F64_TOL
    assert not _misses(got.numpy(), want.numpy())


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_the_split_control_misses_the_f32_tolerance(D, mask):
    """Every tensor-core operand rounded once to bf16: what a textbook
    tensor-core kernel does with f32 inputs."""
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    got, _ = _port(args, **SPLIT_CONTROL, **opts)
    want, _ = _f64(args, **opts)
    assert _misses(got.numpy(), want.numpy())
    assert _gap(got.numpy(), want.numpy(), args[2]) > FLASH_F32_TOL


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_the_lse_of_the_pieces_holds_the_f64_lse(D, mask):
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    out, lse = _port(args, **F32_ROUTE, **opts)
    plain_out, plain_lse = _port(args, **opts)
    _, want = _f64(args, **opts)
    assert torch.isfinite(want).all()
    assert float((lse.double() - want).abs().max()) <= LSE_TOL
    assert float((plain_lse.double() - want).abs().max()) <= LSE_TOL
    assert torch.equal(out, ref.attention_ref(
        *(torch.from_numpy(a) for a in args), **F32_ROUTE, **opts))


def _attention_ref_before(q, k, v, *, causal=True, window=0, softcap=0.0,
                          chunk=512, q_offset=0, p_split=0,
                          return_lse=False):
    """``ref.attention_ref`` as it was before its piece options: the f32
    arithmetic, one einsum a product."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    group = H // KV
    scale = 1.0 / torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    qf = q.float()
    qpos = q_offset + torch.arange(Sq)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32)
    l = torch.zeros((B, H, Sq), dtype=torch.float32)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32)
    for c0 in range(0, Sk, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kpos = c0 + torch.arange(kb.shape[1])
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones(Sq, kb.shape[1], dtype=torch.bool)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = s.masked_fill(~mask, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp(s - m_use[..., None])
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", ref.split_p(p, p_split), vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-37)[..., None]
    out = out.transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, m + torch.log(torch.clamp_min(l, 1e-37))
    return out


@pytest.mark.parametrize("dtype", kernel.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_the_defaults_are_bitwise_the_function_before(mask, dtype):
    _, opts, group, extra = mask
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(64, group, extra))
    for chunk, p_split in ((512, 0), (32, 0), (32, 2)):
        got = ref.attention_ref(q, k, v, chunk=chunk, p_split=p_split,
                                return_lse=True, **opts)
        want = _attention_ref_before(q, k, v, chunk=chunk, p_split=p_split,
                                     return_lse=True, **opts)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_pieces_are_refused_outside_their_range_or_beside_p_split():
    q, k, v = (torch.from_numpy(a) for a in _inputs(16, 1))
    for bad in (dict(in_pieces=4), dict(mid_pieces=-1)):
        with pytest.raises(ValueError, match="pieces"):
            ref.attention_ref(q, k, v, **bad)
    with pytest.raises(ValueError, match="do not mix"):
        ref.attention_ref(q, k, v, p_split=2, in_pieces=3, mid_pieces=3)


def test_the_source_runs_on_the_tensor_cores():
    """The f32 source includes the shared header and issues its products
    with wgmma from TMA-loaded tiles; its CUDA-core product loops and their
    staging are gone."""
    src = kernel.SOURCE.read_text()
    assert '#include "sm90.cuh"' in src
    for needle in ("tma_load(", "wgmma_rs<", "split_scores<", "to_pieces<",
                   "for_pairs<3, 3>", "mbar_wait(", "encode_heads("):
        assert needle in src, needle
    # the tile rules ``shared_memory_bytes(D, "wgmma-f32")`` mirrors
    assert "kBN = L == 256 ? 16 : 32;" in src
    assert [kernel.f32_block_n(D) for D in kernel.HEAD_DIMS] == \
        [32, 32, 32, 32, 32, 16]
    assert f"constexpr int kRows = {kernel.F32_ROWS};" in src
    assert "constexpr int kBQ = 2 * kRows;" in src
    assert kernel.BLOCK_Q == 2 * kernel.F32_ROWS
    assert "stage_tile" not in src and "p_s[" not in src
    assert not re.search(r"fmaf\(q[a-z]*\[", src)
    header = (kernel.SOURCE.parent / "sm90.cuh").read_text()
    assert "flash_attention.cu" in header.split("#pragma once")[0]
    for needle in ("tanh_f32", "split_scores", "to_pieces", "encode_heads"):
        assert needle in header, needle
    assert kernel.route(torch.float32, 64) == "wgmma-f32"
