"""The operand split of the SSD scan's backward kernel, emulated on the CPU.

The backward kernel (``csrc/ssd_scan_bwd.cu``) runs every product on bf16
tensor cores with an f32 accumulator. An f32 operand goes in as three
bf16 pieces (p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1)),
and a product is the sum of the piece products with a + b <= 2. Inputs
of bf16 are one piece; what the kernel computes in f32 (the states and
their gradients, W, dG, the weighted rows of the carries) is always
three. ``ref.ssd_bwd_decomposed`` writes the kernel's decomposition out
with those splits (``in_pieces``, ``mid_pieces``).

On numpy-seeded inputs with Mamba-2's dt and A and a slow decay whose
carry dominates, at mamba2's head and state dims and at small unaligned
ones (P 16, N 16, G 2, a ragged last chunk): the f32 split holds every
leaf far inside ``chip_smoke.py``'s 1e-5 of its max off
``ref.ssd_chunked_grads``, and the bf16 split the rounding rule; a single
bf16 rounding of every operand (the control ``chip_smoke.py`` computes
on the card) fails the rule on every leaf a product feeds, and two
pieces leave no margin at f32 (a factor of 10 at most; past the rule at
mamba2's dims), which is why the kernel takes three.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.testing.tolerances import half_ulp_excess

F64 = torch.float64
F32_TOL = 1e-5  # chip_smoke.py's SSD_BWD_F32_TOL: of each leaf's max
F32_NOISE = 2.0 ** -18  # chip_smoke.py's bf16 rounding rule, over the max
NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dD")
PRODUCT_LEAVES = NAMES[:5]  # dD = sum dy * x takes no product
SHAPES = [(1, 256, 4, 64, 1, 128), (2, 150, 4, 16, 2, 16),
          (1, 200, 6, 32, 3, 64)]  # (B, S, H, P, G, N)
SHAPE_IDS = ["P64N128", "P16N16-G2-ragged", "P32N64-G3-ragged"]
DECAYS = ["mamba2", "slow"]
F32_SPLIT = dict(in_pieces=3, mid_pieces=3)
BF16_SPLIT = dict(in_pieces=1, mid_pieces=3)


def _inputs(shape, decay, dtype=torch.float32, seed=0):
    """x, dt, A, Bm, Cm, D, dy rounded to `dtype` and held in float64 (A
    and D f32): "mamba2" A = -U[1, 16], dt log-uniform in [1e-3, 1e-1];
    "slow" A = -U[0.05, 0.8], dt the same: the carried state dominates."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed + S + P + N)
    a_lo, a_hi = (1.0, 16.0) if decay == "mamba2" else (0.05, 0.8)
    arrays = (rng.normal(size=(B, S, H, P)) * 0.5,
              np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H))),
              -rng.uniform(a_lo, a_hi, H),
              rng.normal(size=(B, S, G, N)) * 0.3,
              rng.normal(size=(B, S, G, N)) * 0.3,
              1.0 + 0.5 * rng.normal(size=H),
              rng.normal(size=(B, S, H, P)))
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(a.astype(np.float32))
        if i not in (2, 5):
            t = t.to(dtype)
        out.append(t.to(F64))
    return out


def _rel(got, want):
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_plain_decomposition_is_the_gradient(shape, decay):
    """Unsplit, the kernel's decomposition is autograd's gradient up to
    float64 rounding."""
    args = _inputs(shape, decay)
    want = ref.ssd_chunked_grads(*args, chunk=64)
    for name, err in zip(NAMES, _rel(ref.ssd_bwd_decomposed(*args), want)):
        assert err <= 1e-9, (name, err)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_f32_split_holds_every_leaf_far_inside_the_rule(shape, decay):
    args = _inputs(shape, decay)
    want = ref.ssd_chunked_grads(*args, chunk=64)
    errs = _rel(ref.ssd_bwd_decomposed(*args, **F32_SPLIT), want)
    for name, err in zip(NAMES, errs):
        assert err <= F32_TOL / 100, (name, err)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("pieces", [1, 2])
def test_fewer_pieces_fail_the_f32_rule(shape, decay, pieces):
    """One piece (a single bf16 rounding: the control) fails on every leaf
    a product feeds; two pieces (2^-16) come within a factor of 10 of the
    rule on some leaf (past it at mamba2's P 64, N 128)."""
    args = _inputs(shape, decay)
    want = ref.ssd_chunked_grads(*args, chunk=64)
    errs = dict(zip(NAMES, _rel(ref.ssd_bwd_decomposed(
        *args, in_pieces=pieces, mid_pieces=pieces), want)))
    if pieces == 1:
        assert all(errs[n] > F32_TOL for n in PRODUCT_LEAVES), errs
    else:
        assert max(errs[n] for n in PRODUCT_LEAVES) > F32_TOL / 10, errs
    assert errs["dD"] <= 1e-12, errs  # no product: no split


def _bf16_excess(shape, decay, **split):
    args = _inputs(shape, decay, dtype=torch.bfloat16)
    want = ref.ssd_chunked_grads(*args, chunk=64)
    got = ref.ssd_bwd_decomposed(*args, **split)
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if name in ("dA", "dD"):  # f32 leaves: 1e-5 of the max
            out[name] = float((g - w).abs().max() / w.abs().max()) - F32_TOL
        else:
            out[name] = half_ulp_excess(w, float(w.abs().max()),
                                        k=g.to(torch.bfloat16))["k"] \
                - F32_NOISE
    return out


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_bf16_split_holds_the_rounding_rule(shape, decay):
    """bf16 inputs, three pieces of every f32 operand: each bf16 leaf
    within half a bf16 ulp + 2^-18 of its max, dA and dD within 1e-5."""
    over = _bf16_excess(shape, decay, **BF16_SPLIT)
    assert all(v <= 0.0 for v in over.values()), over


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_the_bf16_single_rounding_control_fails(shape, decay):
    over = _bf16_excess(shape, decay, in_pieces=1, mid_pieces=1)
    assert all(over[n] > 0.0 for n in PRODUCT_LEAVES), over


def test_three_pieces_hold_an_f32_exactly():
    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32)) * 1e3
    p = ref.bf16_pieces(v, 3)
    assert all(q.dtype == torch.float32 for q in p)
    assert torch.equal(p[0] + p[1] + p[2], v)
    assert torch.equal(p[0], v.to(torch.bfloat16).float())
    two = p[0] + p[1]
    assert float(((two - v).abs() / v.abs()).max()) <= 2.0 ** -16
    assert ref.bf16_pieces(v, 0) == [v]


def test_the_split_options_refuse_other_values():
    args = _inputs((1, 70, 2, 16, 1, 16), "mamba2")
    with pytest.raises(ValueError, match="pieces"):
        ref.ssd_bwd_decomposed(*args, in_pieces=4)
    with pytest.raises(ValueError, match="pieces"):
        ref.bf16_pieces(args[0], -1)
