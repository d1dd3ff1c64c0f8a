"""The flash backward kernel's tensor-core arithmetic, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` forms every product on the bf16 tensor
cores: f32 inputs as three bf16 pieces each (q, k, v, dout, and P and dS
from registers), bf16 inputs as they are with P and dS in two bf16 halves.
``ref.attention_grads(in_pieces=, mid_pieces=)`` writes that arithmetic out
in PyTorch. Here, at small shapes, every head dim and every mask:

* the f32 emulation (3, 3) is within 1e-5 of each gradient's max of the
  f64 gradient and of ``jax.vjp`` of the reference's ``attention_ref`` on
  the same numpy inputs;
* the bf16 emulation (1, 2) on bf16 inputs passes the rounding rule (half a
  bf16 ulp + 2^-18 of each gradient's max) against the f32 gradient;
* the controls fail: every operand rounded once to bf16 (1, 1) the f32 rule
  on every leaf, P rounded once to bf16 the rounding rule on dv, dS rounded
  once to bf16 the rounding rule on dq and dk;
* the defaults are bitwise the function before the options existed.

Also the build's content hash covers the shared header ``csrc/sm90.cuh``.
"""
import math
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ref
from repro_torch.testing.tolerances import half_ulp_excess

F64_TOL = 1e-5  # the f32 route's rule, of each gradient's max
F32_NOISE = 2.0 ** -18  # the bf16 rounding rule's excess, over the max
S = 70  # unaligned: no multiple of any tile
# (id, options, group, extra keys past Sq)
MASKS = [("causal", dict(causal=True), 1, 0),
         ("noncausal", dict(causal=False), 2, 0),
         ("window24_softcap50", dict(causal=True, window=24, softcap=50.0),
          4, 0),
         ("offset7", dict(causal=True, q_offset=7), 2, 7),
         ("noncausal_window20_softcap50",
          dict(causal=False, window=20, softcap=50.0), 1, 0)]
MASK_IDS = [m[0] for m in MASKS]
F32_ROUTE = dict(in_pieces=3, mid_pieces=3)
BF16_ROUTE = dict(in_pieces=1, mid_pieces=2)
SPLIT_CONTROL = dict(in_pieces=1, mid_pieces=1)


@pytest.fixture(scope="module")
def J():
    """The JAX package's reference, imported by the tests that use it."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jax_ref)


def _inputs(D, group, extra=0, H=4, Sq=S, seed=1):
    """q (1,Sq,H,D), k/v (1,Sq+extra,H/group,D), dout (1,Sq,H,D) as numpy
    f32, unit variance."""
    rng = np.random.default_rng(seed + D + 10 * group + extra)
    KV, Sk = H // group, Sq + extra
    return [rng.normal(size=shape).astype(np.float32) for shape in (
        (1, Sq, H, D), (1, Sk, KV, D), (1, Sk, KV, D), (1, Sq, H, D))]


def _grads(args, dtype=torch.float32, **opts_and_pieces):
    """ref.attention_grads from ref.attention_ref's out and lse, the inputs
    rounded to `dtype` and taken in f32 (as the kernel takes them)."""
    opts = {k: v for k, v in opts_and_pieces.items()
            if k in ("causal", "window", "softcap", "q_offset")}
    q, k, v, dout = (torch.from_numpy(a).to(dtype) for a in args)
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **opts)
    f = [t.float() for t in (q, k, v, out)]
    return ref.attention_grads(*f, lse, dout.float(), **opts_and_pieces)


def _f64_grads(args, **opts):
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in args[:3])
    out = ref.attention_naive(q, k, v, **opts)
    return torch.autograd.grad(out, (q, k, v),
                               torch.from_numpy(args[3]).double())


def _gaps(got, want):
    """Each gradient's max |got - want| over its own max |want|."""
    return [float(np.abs(np.asarray(g, np.float64) - np.asarray(w)).max()
                  / np.abs(np.asarray(w)).max()) for g, w in zip(got, want)]


def _excess(got, want):
    """Each bf16 gradient's excess over half a bf16 ulp of the f32 one,
    over the f32 one's max."""
    return [half_ulp_excess(w, float(w.abs().max()),
                            kernel=g.to(torch.bfloat16))["kernel"]
            for g, w in zip(got, want)]


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_f32_pieces_hold_the_f64_gradient_and_jax_vjp(J, D, mask):
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    got = [g.numpy() for g in _grads(args, **F32_ROUTE, **opts)]
    gaps = _gaps(got, [g.numpy() for g in _f64_grads(args, **opts)])
    assert max(gaps) <= F64_TOL, gaps
    q, k, v, dout = (J.jnp.asarray(a) for a in args)
    _, vjp = J.jax.vjp(lambda q, k, v: J.ref.attention_ref(q, k, v, **opts),
                       q, k, v)
    want = [np.asarray(g) for g in vjp(dout)]
    assert all(np.isfinite(w).all() for w in want)
    gaps = _gaps(got, want)
    assert max(gaps) <= F64_TOL, gaps


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_bf16_halves_pass_the_rounding_rule(D, mask):
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    want = _grads(args, torch.bfloat16, **opts)
    got = _grads(args, torch.bfloat16, **BF16_ROUTE, **opts)
    ex = _excess(got, want)
    assert max(ex) <= F32_NOISE, ex


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_the_split_control_fails_the_f32_rule_on_every_leaf(D, mask):
    """Every tensor-core operand rounded once to bf16: what a textbook
    tensor-core kernel does with f32 inputs."""
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    want = [g.numpy() for g in _f64_grads(args, **opts)]
    gaps = _gaps([g.numpy() for g in _grads(args, **SPLIT_CONTROL, **opts)],
                 want)
    assert min(gaps) > F64_TOL, gaps


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_p_and_ds_in_bf16_fail_the_rounding_rule(D, mask):
    """P rounded once to bf16 before dV fails the rule on dv; dS rounded
    once before dQ and dK fails it on dq and dk."""
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    want = _grads(args, torch.bfloat16, **opts)
    p_ex = _excess(_grads(args, torch.bfloat16, **BF16_ROUTE, p_split=1,
                          **opts), want)
    ds_ex = _excess(_grads(args, torch.bfloat16, **BF16_ROUTE, ds_split=1,
                           **opts), want)
    assert p_ex[2] > F32_NOISE, p_ex
    assert min(ds_ex[:2]) > F32_NOISE, ds_ex


def _attention_grads_before(q, k, v, out, lse, dout, *, causal=True,
                            window=0, softcap=0.0, q_offset=0, chunk=512):
    """``ref.attention_grads`` as it was before its piece options: the
    f32 arithmetic, one einsum a product."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    group = H // KV
    scale = 1.0 / torch.tensor(math.sqrt(D), dtype=torch.float32).to(q.dtype)
    scale = scale.float()
    qh = q.float().transpose(1, 2)
    kh = k.float().repeat_interleave(group, dim=2).transpose(1, 2)
    vh = v.float().repeat_interleave(group, dim=2).transpose(1, 2)
    doh = dout.float().transpose(1, 2)
    delta = (doh * out.float().transpose(1, 2)).sum(-1)
    lse = lse.float()
    qpos = q_offset + torch.arange(Sq)
    dq = torch.zeros_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for c0 in range(0, Sk, chunk):
        kb, vb = kh[:, :, c0:c0 + chunk], vh[:, :, c0:c0 + chunk]
        kpos = c0 + torch.arange(kb.shape[2])
        s = torch.einsum("bhqd,bhkd->bhqk", qh, kb) * scale
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s = softcap * t
        mask = torch.ones(Sq, kb.shape[2], dtype=torch.bool)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= qpos[:, None] - kpos[None, :] < window
        p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
        dv[:, :, c0:c0 + chunk] = torch.einsum("bhqk,bhqd->bhkd", p, doh)
        dp = torch.einsum("bhqd,bhkd->bhqk", doh, vb)
        ds = p * (dp - delta[..., None])
        if softcap > 0:
            ds = ds * (1.0 - t * t)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dk[:, :, c0:c0 + chunk] = torch.einsum("bhqk,bhqd->bhkd", ds,
                                               qh) * scale
    dq = (dq * scale).transpose(1, 2).to(q.dtype)

    def by_kv_head(g):
        return g.view(B, KV, group, Sk, D).sum(2).transpose(1, 2)

    return dq, by_kv_head(dk).to(k.dtype), by_kv_head(dv).to(v.dtype)


@pytest.mark.parametrize("dtype", kernel.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_the_defaults_are_bitwise_the_function_before(mask, dtype):
    _, opts, group, extra = mask
    q, k, v, dout = (torch.from_numpy(a).to(dtype)
                     for a in _inputs(64, group, extra))
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **opts)
    for chunk in (512, 32):
        got = ref.attention_grads(q, k, v, out, lse, dout, chunk=chunk,
                                  **opts)
        want = _attention_grads_before(q, k, v, out, lse, dout, chunk=chunk,
                                       **opts)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_pieces_are_refused_outside_their_range():
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(16, 1))
    out, lse = ref.attention_ref(q, k, v, return_lse=True)
    for bad in (dict(in_pieces=4), dict(mid_pieces=-1)):
        with pytest.raises(ValueError, match="pieces"):
            ref.attention_grads(q, k, v, out, lse, dout, **bad)


def test_the_library_hash_covers_the_shared_header(tmp_path):
    """Editing a header beside a source (``csrc/sm90.cuh``) moves every
    library path, so the next build compiles it again."""
    src = tmp_path / "k.cu"
    src.write_text('#include "sm90.cuh"\n')
    header = tmp_path / "sm90.cuh"
    header.write_text("// one\n")
    first = kbuild.library_path(src)
    assert kbuild.library_path(src) == first
    header.write_text("// two\n")
    assert kbuild.library_path(src) != first
    real = kernel.BWD_SOURCE
    assert (real.parent / "sm90.cuh").exists()
    assert '#include "sm90.cuh"' in real.read_text()


def test_the_shared_header_holds_the_backward_helpers():
    text = (kernel.BWD_SOURCE.parent / "sm90.cuh").read_text()
    for needle in ("mbarrier.try_wait", "cp.async.bulk.tensor",
                   "wgmma.mma_async", "smem_desc", "fence_regs", "split3",
                   "for_pairs", "pack_bf16"):
        assert needle in text, needle
    src = kernel.BWD_SOURCE.read_text()
    for needle in ("tma_load(", "wgmma_rs<", "wgmma_ss64(", "bar_sync("):
        assert needle in src, needle
    # the CUDA-core product loops and their f32 staging are gone
    assert "stage_tile" not in src
    assert not re.search(r"fmaf\([a-z]+\[i\]\.[xyzw]", src)
