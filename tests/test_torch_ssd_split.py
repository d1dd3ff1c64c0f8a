"""The splits of the bf16 SSD-scan kernel, emulated on the CPU.

The wgmma kernel (``csrc/ssd_scan_wgmma.cu``) cannot run here, but its
numerical departures from the f32 CUDA-core kernel can. It feeds three
f32 operands to bf16 tensor-core products, each as hi + lo (hi = bf16(v),
lo = bf16(v - hi), two passes into one f32 accumulator): the intra-chunk
weights W in W . x, the carried state as C . state reads it, and the
operand x_j w_j of the state update. ``ref.ssd_chunk_terms`` models each
(``w_split``, ``state_split``, ``update_split``: 0 f32, 1 bf16 once,
2 hi + lo).

On bf16 inputs from a numpy seed, with Mamba-2's dt and A and a slow
decay whose carry dominates, at the mamba2-130m head and state dims and
at smaller unaligned ones, the split must hold the rounding rule of
``chip_smoke.py``: each output within half a bf16 ulp of the f32 result,
plus 2^-18 max|y|. Each operand rounded once to bf16 must fail it: those
are the controls ``chip_smoke.py`` holds beside the kernel. The f32
result is held to the JAX package's chunked SSD.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.testing.tolerances import half_ulp_excess

F32_NOISE = 2.0 ** -18  # chip_smoke.py's bf16 rounding rule, over max|y|
CHUNK = 64  # the wgmma kernel's chunk
SHAPES = [(1, 1024, 8, 64, 1, 128), (2, 300, 4, 32, 2, 64),
          (1, 333, 6, 64, 3, 32), (2, 257, 4, 16, 1, 128),
          (1, 200, 4, 16, 1, 16)]  # (B, S, H, P, G, N)
SHAPE_IDS = ["P64N128", "P32N64-G2", "P64N32-G3", "P16N128", "P16N16"]
DECAYS = ["mamba2", "slow"]
KERNEL = dict(w_split=2, state_split=2, update_split=2)
CONTROLS = {"w_bf16": dict(w_split=1), "state_bf16": dict(state_split=1),
            "update_bf16": dict(update_split=1)}


def _inputs(shape, decay, seed=0):
    """x, dt, Bm, Cm rounded to bf16 and held in f32, A and D f32. "mamba2":
    A = -U[1, 16], dt log-uniform in [1e-3, 1e-1]; "slow": A = -U[0.5, 1],
    dt log-uniform in [1e-3, 1e-2]."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed + S + P + N)
    lo, hi, a_lo, a_hi = ((1e-3, 1e-1, 1.0, 16.0) if decay == "mamba2"
                          else (1e-3, 1e-2, 0.5, 1.0))
    f32 = np.float32
    x = rng.normal(size=(B, S, H, P)) * 0.5
    dt = np.exp(rng.uniform(np.log(lo), np.log(hi), (B, S, H)))
    A = -rng.uniform(a_lo, a_hi, H)
    Bm = rng.normal(size=(B, S, G, N)) * 0.3
    Cm = rng.normal(size=(B, S, G, N)) * 0.3
    D = 1.0 + 0.5 * rng.normal(size=H)
    bf = [torch.from_numpy(a.astype(f32)).to(torch.bfloat16).float()
          for a in (x, dt, Bm, Cm)]
    return (bf[0], bf[1], torch.from_numpy(A.astype(f32)), bf[2], bf[3],
            torch.from_numpy(D.astype(f32)))


def _y(x, dt, A, Bm, Cm, D, **splits):
    """The chunked SSD plus D x in f32 at the kernel's chunk."""
    y_intra, y_inter = ref.ssd_chunk_terms(x, dt, A, Bm, Cm, chunk=CHUNK,
                                           **splits)
    return y_intra + y_inter + D[None, None, :, None] * x


def _excess(shape, decay, **variants):
    args = _inputs(shape, decay)
    oracle = _y(*args)
    outs = {name: _y(*args, **splits).to(torch.bfloat16)
            for name, splits in variants.items()}
    return half_ulp_excess(oracle, float(oracle.abs().max()), **outs)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_kernels_split_holds_the_rounding_rule(shape, decay):
    ex = _excess(shape, decay, kernel=KERNEL, f32={})
    assert ex["kernel"] <= F32_NOISE, ex
    assert ex["f32"] <= 0.0, ex  # the f32 result, correctly rounded


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("control", CONTROLS)
def test_each_single_rounding_control_fails_the_rule(shape, decay, control):
    """Each operand rounded once to bf16, the others split: the rule must
    see it, or it could not tell such a kernel from the split one."""
    ex = _excess(shape, decay, control={**KERNEL, **CONTROLS[control]})
    assert ex["control"] > F32_NOISE, ex


@pytest.mark.parametrize("shape", SHAPES[:3], ids=SHAPE_IDS[:3])
def test_the_defaults_are_the_f32_arithmetic(shape):
    """Splits of 0 change nothing: ssd_chunked_ref is bitwise what it was."""
    x, dt, A, Bm, Cm, D = _inputs(shape, "mamba2")
    default = ref.ssd_chunk_terms(x, dt, A, Bm, Cm, chunk=CHUNK)
    zero = ref.ssd_chunk_terms(x, dt, A, Bm, Cm, chunk=CHUNK, w_split=0,
                               state_split=0, update_split=0)
    assert all(torch.equal(a, b) for a, b in zip(default, zero))
    y = default[0] + default[1] + D[None, None, :, None] * x
    assert torch.equal(ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=CHUNK),
                       y.to(x.dtype))


@pytest.mark.parametrize("decay", DECAYS)
def test_the_split_and_the_oracle_match_the_jax_chunked_ssd(decay):
    """The f32 oracle and the split emulation against the JAX package's
    ssd_chunked at its own tolerance (1e-4), at a chunk dividing S."""
    import jax.numpy as jnp
    from repro.models import ssm as jax_ssm
    args = _inputs((1, 256, 4, 64, 1, 128), decay)
    want = np.asarray(jax_ssm.ssd_chunked(
        *(jnp.asarray(a.numpy()) for a in args), chunk=CHUNK))
    for splits in ({}, KERNEL):
        got = _y(*args, **splits).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_the_split_options_refuse_other_values():
    args = _inputs((1, 70, 2, 16, 1, 16), "mamba2")[:5]
    for name in ("w_split", "state_split", "update_split"):
        with pytest.raises(ValueError, match="split"):
            ref.ssd_chunk_terms(*args, chunk=CHUNK, **{name: 3})
