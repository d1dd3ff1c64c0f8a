"""The SSD scan's backward: its plain version and the kernel's formulas.

``ref.ssd_chunked_grads`` (autograd through the plain chunked scan) is
the plain version of the backward kernel, ``csrc/ssd_scan_bwd.cu``. Here
it is held to ``torch.autograd.gradcheck`` at float64 on tiny shapes, as
the backward of an autograd function whose forward is the plain scan.
Then the kernel's own decomposition (a forward sweep storing the state
entering each 64-step chunk, a reverse sweep storing the gradient of the
state leaving it, and the per-chunk terms of the source's note, taken as
the kernel takes them: transposed products, raw = dS B^T in 64-wide
tiles of N, dB and dC summed over a group's heads in ascending order),
``ref.ssd_bwd_decomposed`` unsplit in float64, is held to that plain
gradient at 1e-9 relative to each leaf's max, so the arithmetic the
kernel runs is checked on the CPU (its bf16 splits:
``tests/test_torch_ssd_bwd_split.py``). ``ops.ssd_scan_bwd`` takes the
plain version for CPU tensors and counts nothing. The one test that needs
the card (marked ``gpu``) holds the kernel against the plain version
there; it decides inside its body whether to skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kernel

F64 = torch.float64
NAMES = ("x", "dt", "A", "Bm", "Cm", "D")
# the kernel's formulas against autograd, both in float64: rounding only
MIRROR_TOL = 1e-9


def _inputs(B, S, H, P, G, N, dtype=torch.float32, seed=0):
    """x, dt, A, Bm, Cm, D, dy as Mamba-2 draws them (A = -U[1, 16], dt
    log-uniform in [1e-3, 1e-1]), from numpy."""
    rng = np.random.default_rng(seed)
    arrays = (
        rng.normal(size=(B, S, H, P)) * 0.5,
        np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H))),
        -rng.uniform(1.0, 16.0, H),
        rng.normal(size=(B, S, G, N)) * 0.3,
        rng.normal(size=(B, S, G, N)) * 0.3,
        1.0 + 0.5 * rng.normal(size=H),
        rng.normal(size=(B, S, H, P)),
    )
    return [torch.from_numpy(a).to(dtype) for a in arrays]


class _PlainScan(torch.autograd.Function):
    """The plain scan, differentiated by ``ref.ssd_chunked_grads``."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        grads = ref.ssd_chunked_grads(*ctx.saved_tensors, dy,
                                      chunk=ctx.chunk)
        return (*grads, None)


@pytest.mark.parametrize("shape,chunk", [
    ((1, 6, 2, 2, 1, 2), 4),  # a ragged last chunk
    ((2, 8, 2, 3, 2, 2), 4),  # G = 2: dB and dC sum over no heads
    ((1, 9, 4, 2, 2, 3), 3),  # two heads a group
])
def test_plain_gradient_passes_gradcheck_at_float64(shape, chunk):
    args = _inputs(*shape, dtype=F64)[:6]
    args[1] = args[1] * 5.0  # decays well inside (0, 1) over a chunk
    leaves = [a.clone().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(
        lambda *t: _PlainScan.apply(*t, chunk), leaves, eps=1e-6,
        atol=1e-7, rtol=1e-6)


def test_plain_gradient_types_and_no_d():
    x, dt, A, Bm, Cm, D, dy = _inputs(1, 20, 2, 4, 1, 4)
    bf16 = [t.to(torch.bfloat16) for t in (x, dt, Bm, Cm, dy)]
    g = ref.ssd_chunked_grads(bf16[0], bf16[1], A, bf16[2], bf16[3], D,
                              bf16[4])
    assert [t.dtype for t in g] == [torch.bfloat16] * 2 + [torch.float32] \
        + [torch.bfloat16] * 2 + [torch.float32]
    g = ref.ssd_chunked_grads(x, dt, A, Bm, Cm, None, dy)
    assert g[5] is None and all(t.dtype == torch.float32 for t in g[:5])


@pytest.mark.parametrize("shape", [
    (2, 150, 4, 16, 2, 16),  # a ragged last chunk, two heads a group
    (1, 128, 3, 8, 1, 8),  # every head in one group
])
def test_the_kernels_formulas_equal_the_plain_gradient(shape):
    x, dt, A, Bm, Cm, D, dy = _inputs(*shape, dtype=F64, seed=1)
    A = A * 0.05  # a slow decay: the carried state and its gradient matter
    want = ref.ssd_chunked_grads(x, dt, A, Bm, Cm, D, dy, chunk=64)
    got = ref.ssd_bwd_decomposed(x, dt, A, Bm, Cm, D, dy)
    for name, g, w in zip(NAMES, got, want):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= MIRROR_TOL, (name, err)
    # the control: without the carried dS the gradient is far off
    no_carry = ref.ssd_chunked_grads(
        *[t.reshape(-1, 64, *t.shape[2:]) if t.dim() > 1 else t
          for t in (x[:, :128], dt[:, :128], A, Bm[:, :128], Cm[:, :128],
                    D, dy[:, :128])], chunk=64)
    full = ref.ssd_chunked_grads(x[:, :128], dt[:, :128], A, Bm[:, :128],
                                 Cm[:, :128], D, dy[:, :128], chunk=64)
    gap = float((no_carry[0].reshape(full[0].shape) - full[0]).abs().max()
                / full[0].abs().max())
    assert gap > 1e3 * MIRROR_TOL, gap


def test_ops_on_cpu_takes_the_plain_version_and_counts_nothing():
    args = _inputs(1, 70, 2, 16, 1, 16)
    before = ops.ssd_scan_bwd.launches
    got = ops.ssd_scan_bwd(*args)
    want = ref.ssd_chunked_grads(*args, chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.ssd_scan_bwd.launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ssd_scan_bwd(*args, force="cuda")
    with pytest.raises(ValueError, match="force"):
        ops.ssd_scan_bwd(*args, force="pallas")


def test_autograd_through_ops_on_cpu_is_the_plain_gradient():
    """On CPU tensors ops.ssd_scan is the plain version, which autograd
    differentiates: the same gradient as ssd_chunked_grads at its chunk."""
    x, dt, A, Bm, Cm, D, dy = _inputs(1, 96, 2, 16, 1, 16, seed=2)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    ops.ssd_scan(*leaves, chunk=32).backward(dy)
    want = ref.ssd_chunked_grads(x, dt, A, Bm, Cm, D, dy, chunk=32)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name


def test_check_bwd_args_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm, D, dy = _inputs(1, 8, 2, 16, 1, 16)
    kernel.check_bwd_args(x, dt, A, Bm, Cm, D, dy)
    kernel.check_bwd_args(x, dt, A, Bm, Cm, None, dy)
    with pytest.raises(ValueError, match="dy"):
        kernel.check_bwd_args(x, dt, A, Bm, Cm, D, dy[:, :4])
    with pytest.raises(ValueError, match="dy"):
        kernel.check_bwd_args(x, dt, A, Bm, Cm, D, dy.double())
    with pytest.raises(ValueError, match="last axis of dy"):
        kernel.check_bwd_args(x, dt, A, Bm, Cm, D,
                              dy.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="head dim"):
        kernel.check_bwd_args(x[..., :8], dt, A, Bm, Cm, D, dy[..., :8])
    with pytest.raises(ValueError, match="contiguous"):
        kernel.check_bwd_args(x.transpose(1, 2).contiguous().transpose(1, 2),
                              dt, A, Bm, Cm, D, dy)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(Bm.numel() + 1)
        kernel.check_bwd_args(x, dt, A, Bm, flat[1:].view(Bm.shape), D, dy)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, D, dy)


def test_every_shape_fits_the_shared_memory_budget():
    from repro_torch.kernels.build import SHARED_MEMORY_BUDGET
    for dtype in kernel.DTYPE_CODES:
        for P in kernel.HEAD_DIMS:
            for N in kernel.STATE_DIMS:
                need = kernel.bwd_shared_memory_bytes(P, N, dtype)
                assert max(need.values()) <= SHARED_MEMORY_BUDGET, need
    # the largest, as the source's SweepCfg and ChunkCfg lay it out
    assert kernel.bwd_shared_memory_bytes(64, 128) == {"sweep": 186_432,
                                                       "chunk": 229_248}


def test_the_sums_scratch_is_per_group_not_per_head():
    """At N = 128 the per-chunk kernel keeps its dB and dC sums in an f32
    scratch of 2 tiles x 2 sums x 16 registers x 128 threads per block and
    warpgroup: (B, chunks, G, ...), no H axis."""
    assert kernel.bwd_sums_shape(8, 2048, 1, 128) == (8, 32, 1, 2, 2, 2,
                                                       16, 128)
    assert kernel.bwd_sums_shape(2, 130, 3, 128)[:3] == (2, 3, 3)
    with pytest.raises(ValueError, match="N = 128"):
        kernel.bwd_sums_shape(8, 2048, 1, 64)


def test_the_source_is_listed_and_deterministic_by_construction():
    code = kernel.BWD_SOURCE.read_text()
    assert kernel.BWD_SOURCE in kernel.SOURCES
    assert "atomicAdd" not in code and "__expf" not in code
    assert "_part" not in code.replace("dA_part", "").replace("dD_part", "")
    assert f"constexpr int kQ = {kernel.CHUNK};" in code
    assert f"constexpr int kMid = {kernel.BWD_MID_PIECES};" in code
    # three bf16 pieces for an f32 input, one for a bf16
    assert "struct In<float> {\n  static constexpr int kPieces = 3;" in code
    # the products are wgmma, the loads TMA
    assert "wgmma.mma_async.sync.aligned" in code
    assert "cp.async.bulk.tensor" in code
    for P in kernel.HEAD_DIMS:
        assert f"dispatch_n<T, {P}>" in code
    for N in kernel.STATE_DIMS:
        assert f"launch<T, P, {N}>" in code


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300, 4, 64, 1, 128),
                                   (2, 150, 4, 16, 2, 16),
                                   (1, 333, 6, 32, 2, 32),
                                   (1, 200, 3, 64, 3, 64)],
                         ids=["P64N128", "P16N16-G2-ragged",
                              "P32N32-rep3-ragged", "P64N64-H=G-ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_the_card(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [t.cuda() for t in _inputs(*shape, seed=3)]
    x, dt, A, Bm, Cm, D, dy = args
    cast = [t.to(dtype) for t in (x, dt)] + [A] + \
        [t.to(dtype) for t in (Bm, Cm)] + [D, dy.to(dtype)]
    a = ops.ssd_scan_bwd(*cast, force="cuda")
    b = ops.ssd_scan_bwd(*cast, force="cuda")
    want = ref.ssd_chunked_grads(*[t.float() for t in cast], chunk=64)
    torch.cuda.synchronize()
    for name, g, h, w in zip(NAMES, a, b, want):
        assert torch.equal(g, h), name
        scale = float(w.abs().max())
        if dtype == torch.float32 or g.dtype == torch.float32:
            assert float((g.float() - w).abs().max()) <= 1e-5 * scale, name
        else:
            exponent = torch.frexp(w.abs().clamp_min(2.0 ** -126))[1]
            half_ulp = torch.exp2((exponent - 9).float())
            excess = float(((g.float() - w).abs() - half_ulp).max())
            assert excess <= 2.0 ** -18 * scale, name
