"""The operand split of the SSD scan's f32 forward kernel, emulated on the CPU.

The f32 forward kernel (``csrc/ssd_scan.cu``) runs every product on bf16
tensor cores with an f32 accumulator. Every operand goes in as three bf16
pieces (p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1)): the f32
inputs x, B and C, and what the kernel forms in f32 (W, the carried state
as C . state reads it, x_j u_j of the state update). A product is the sum
of the piece products with a + b <= 2. ``ref.ssd_chunk_terms(in_pieces=,
mid_pieces=)`` writes those products out in PyTorch.

On numpy-seeded inputs with Mamba-2's dt and A and a slow decay whose
carry dominates, at mamba2's head and state dims and at small unaligned
ones (P 16, N 16, G 2, a ragged last chunk): three pieces hold y far
inside ``chip_smoke.py``'s 1e-5 of max|y| off the f64 plain result, and a
single bf16 rounding of every operand (the control ``chip_smoke.py``
computes on the card) fails it. Two pieces hold the rule on the CPU, but
only by a factor of 6-20, not the 100 asked of the emulation: they leave
no room for the accumulator's own truncation on the card, which is why
the kernel takes three.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.testing.tolerances import F32_REDUCTION

F64 = torch.float64
F32_TOL = 1e-5  # chip_smoke.py's SSD_F32_ORACLE_TOL: of max|y|
CHUNK = 64  # the kernel's chunk
SHAPES = [(1, 256, 4, 64, 1, 128), (2, 150, 4, 16, 2, 16),
          (1, 200, 6, 32, 3, 64)]  # (B, S, H, P, G, N)
SHAPE_IDS = ["P64N128", "P16N16-G2-ragged", "P32N64-G3-ragged"]
DECAYS = ["mamba2", "slow"]
KERNEL = dict(in_pieces=3, mid_pieces=3)


def _inputs(shape, decay, seed=0):
    """x, dt, A, Bm, Cm, D as f32 values held in float64: "mamba2"
    A = -U[1, 16], dt log-uniform in [1e-3, 1e-1]; "slow" A = -U[0.05,
    0.8], dt the same: the carried state dominates."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed + S + P + N)
    a_lo, a_hi = (1.0, 16.0) if decay == "mamba2" else (0.05, 0.8)
    arrays = (rng.normal(size=(B, S, H, P)) * 0.5,
              np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H))),
              -rng.uniform(a_lo, a_hi, H),
              rng.normal(size=(B, S, G, N)) * 0.3,
              rng.normal(size=(B, S, G, N)) * 0.3,
              1.0 + 0.5 * rng.normal(size=H))
    return [torch.from_numpy(a.astype(np.float32)).to(F64) for a in arrays]


def _y(x, dt, A, Bm, Cm, D, **pieces):
    """The chunked SSD plus D x at the kernel's chunk."""
    y_intra, y_inter = ref.ssd_chunk_terms(x, dt, A, Bm, Cm, chunk=CHUNK,
                                           **pieces)
    return y_intra + y_inter + D[None, None, :, None] * x


def _rel(shape, decay, pieces):
    """|y - oracle| / max|oracle| of the decomposition at `pieces` (in,
    mid), the oracle the unsplit f64 result."""
    args = _inputs(shape, decay)
    oracle = _y(*args)
    got = _y(*args, in_pieces=pieces[0], mid_pieces=pieces[1])
    return float((got - oracle).abs().max() / oracle.abs().max())


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_three_pieces_hold_y_far_inside_the_rule(shape, decay):
    assert _rel(shape, decay, (3, 3)) <= F32_TOL / 100


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_one_piece_the_control_fails_the_rule(shape, decay):
    """Every operand rounded once to bf16, what a textbook tensor-core
    kernel does: 3e-4 to 1.3e-3 of max|y| off."""
    assert _rel(shape, decay, (1, 1)) > F32_TOL


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_two_pieces_hold_the_rule_without_the_margin(shape, decay):
    """Two pieces (2^-16 an operand) come 4.8e-7 to 1.7e-6 of max|y| off:
    inside 1e-5, outside the hundredth of it that three pieces keep."""
    rel = _rel(shape, decay, (2, 2))
    assert F32_TOL / 100 < rel <= F32_TOL, rel


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_defaults_are_the_f32_arithmetic(shape):
    """Pieces of 0 change nothing (ssd_chunked_ref is bitwise what it
    was), and three pieces of inputs that are bf16 numbers are those
    numbers: with the computed operands unsplit, C . B^T and W . x are the
    f32 products bit for bit (y_intra; y_inter splits C exp(cum), no bf16
    number)."""
    args = [t.float() for t in _inputs(shape, "mamba2")]
    x, dt, A, Bm, Cm, D = args
    default = ref.ssd_chunk_terms(x, dt, A, Bm, Cm, chunk=CHUNK)
    zero = ref.ssd_chunk_terms(x, dt, A, Bm, Cm, chunk=CHUNK, in_pieces=0,
                               mid_pieces=0)
    assert all(torch.equal(a, b) for a, b in zip(default, zero))
    assert torch.equal(ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=CHUNK),
                       default[0] + default[1] + D[None, None, :, None] * x)
    bf = [t.to(torch.bfloat16).float() for t in (x, Bm, Cm)]
    plain = ref.ssd_chunk_terms(bf[0], dt, A, bf[1], bf[2], chunk=CHUNK)
    split = ref.ssd_chunk_terms(bf[0], dt, A, bf[1], bf[2], chunk=CHUNK,
                                in_pieces=3)
    assert torch.equal(plain[0], split[0])


@pytest.mark.parametrize("decay", DECAYS)
def test_the_split_matches_the_jax_chunked_ssd(decay):
    """The kernel's decomposition in f32 against the JAX package's
    ``models/ssm.py::ssd_chunked`` at F32_REDUCTION, at a chunk dividing
    S."""
    import jax.numpy as jnp
    from repro.models import ssm as jax_ssm
    args = [t.float() for t in _inputs((1, 256, 4, 64, 1, 128), decay)]
    want = np.asarray(jax_ssm.ssd_chunked(
        *(jnp.asarray(a.numpy()) for a in args), chunk=CHUNK))
    got = _y(*args, **KERNEL).numpy()
    tol = F32_REDUCTION.w_rel
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("opts, match", [
    pytest.param({"in_pieces": 4}, "in_pieces must be", id="in_pieces"),
    pytest.param({"mid_pieces": 4}, "mid_pieces must be", id="mid_pieces"),
    # the bf16 kernel's hi + lo splits and the f32 kernel's pieces are two
    # emulations; one call takes one of them
    *(pytest.param({split: 2, pieces: 3}, "do not mix",
                   id=f"{split}-{pieces}")
      for split in ("w_split", "state_split", "update_split")
      for pieces in ("in_pieces", "mid_pieces"))])
def test_the_pieces_refuse_other_values(opts, match):
    args = _inputs((1, 70, 2, 16, 1, 16), "mamba2")[:5]
    with pytest.raises(ValueError, match=match):
        ref.ssd_chunk_terms(*args, chunk=CHUNK, **opts)
