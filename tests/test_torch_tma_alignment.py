"""Views whose data is not 16-byte aligned, on the wgmma routes.

TMA reads the wgmma kernels' operands (q, k, v of ``flash_attention`` on
both its routes, bf16 and f32; x, B, C of ``ssd_scan``), and TMA wants
their data 16-byte aligned. A contiguous view such as
``buf[1:1 + n].view(shape)`` of a bf16 or f32 buffer starts 2 or 4 bytes
past that, so ``ops`` hands such an operand to the kernel through
``ops.tma_operand``: the tensor itself where it is contiguous and aligned,
else a contiguous, aligned copy. ``check_args`` still refuses an
unaligned operand (``tests/test_torch_ssd_route.py``).

On the CPU the helper is held on CPU tensors. The test marked ``gpu``
holds each wgmma route's output on offset views bitwise to the output on
aligned copies; it decides inside its body whether to skip, so every
pytest-xdist worker collects the same tests.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ssd_scan as ssd

BF16 = torch.bfloat16


def _offset_view(t):
    """`t`'s values in a contiguous view one element into a flat buffer."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _randn(*shape, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(BF16).to(device)


def test_aligned_contiguous_operand_is_not_copied():
    t = _randn(2, 40, 4, 64)
    assert t.data_ptr() % ops.TMA_ALIGNMENT == 0
    assert ops.tma_operand(t) is t


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_offset_view_is_copied_to_aligned_data(dtype):
    t = _randn(2, 40, 4, 64).to(dtype)
    view = _offset_view(t)
    assert view.is_contiguous() and view.data_ptr() % ops.TMA_ALIGNMENT
    got = ops.tma_operand(view)
    assert got.data_ptr() % ops.TMA_ALIGNMENT == 0
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, t)
    assert view.data_ptr() % ops.TMA_ALIGNMENT  # the caller's view is kept


def test_strided_view_is_made_contiguous_once():
    wide = _randn(2, 40, 4, 128)
    view = wide[..., :64]
    got = ops.tma_operand(view)
    assert got.is_contiguous() and got.data_ptr() % ops.TMA_ALIGNMENT == 0
    assert torch.equal(got, view)
    assert ops.tma_operand(got) is got


def test_check_args_still_refuses_an_unaligned_operand():
    """The helper repairs ``ops``; the kernel's own check refuses an
    unaligned operand on both routes (f32's reads q, k and v with TMA
    too)."""
    for dtype in (BF16, torch.float32):
        q = _offset_view(_randn(1, 64, 2, 64).to(dtype))
        k, v = (_randn(1, 64, 1, 64, seed=s).to(dtype) for s in (1, 2))
        with pytest.raises(ValueError, match="aligned"):
            flash.check_args(q, k, v)
        with pytest.raises(ValueError, match="aligned"):
            flash.check_args(ops.tma_operand(q).clone(), _offset_view(k), v)
        flash.check_args(ops.tma_operand(q), k, v)


def _ssd_args(device, S=300, H=4, P=64, N=128):
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(2, S, H, P, generator=gen) * 0.5).to(BF16)
    dt = (torch.rand(2, S, H, generator=gen) * 0.1 + 1e-3).to(BF16)
    A = -(torch.rand(H, generator=gen) * 15 + 1)
    Bm = (torch.randn(2, S, 1, N, generator=gen) * 0.3).to(BF16)
    Cm = (torch.randn(2, S, 1, N, generator=gen) * 0.3).to(BF16)
    D = 1 + torch.randn(H, generator=gen) * 0.5
    return [t.to(device) for t in (x, dt, A, Bm, Cm, D)]


def test_offset_views_on_the_cpu_take_the_plain_version_unchanged():
    """On CPU tensors ``ops`` takes the plain versions, which read any
    view: the offset views give the aligned copies' output."""
    q, k, v = (_randn(1, 70, h, 64, seed=s) for s, h in ((0, 2), (1, 1),
                                                          (2, 1)))
    want = ops.flash_attention(q, k, v)
    got = ops.flash_attention(*(_offset_view(t) for t in (q, k, v)))
    assert torch.equal(got, want)
    args = _ssd_args("cpu", S=70)
    want = ops.ssd_scan(*args)
    for i in (0, 3, 4):
        args[i] = _offset_view(args[i])
    assert torch.equal(ops.ssd_scan(*args), want)


@pytest.mark.gpu
def test_offset_bf16_views_run_the_wgmma_routes_bitwise():
    """Offset bf16 views of q/k/v and x/B/C, and offset f32 views of q/k/v,
    launch the wgmma kernels and give bitwise the output of the aligned
    copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_tma_alignment.py)")
    for dtype, route in ((BF16, "wgmma"), (torch.float32, "wgmma-f32")):
        q, k, v = (_randn(2, 200, h, 64, device="cuda", seed=s).to(dtype)
                   for s, h in ((0, 4), (1, 2), (2, 2)))
        assert flash.route(dtype, 64) == route
        want = ops.flash_attention(q, k, v, force="cuda")
        views = [_offset_view(t) for t in (q, k, v)]
        assert all(t.data_ptr() % ops.TMA_ALIGNMENT for t in views)
        got = ops.flash_attention(*views, force="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got, want), dtype

    args = _ssd_args("cuda")
    assert ssd.route(BF16, 64, 128) == "wgmma"
    before = ops.ssd_scan.route_launches["wgmma"]
    want = ops.ssd_scan(*args, force="cuda")
    for i in (0, 3, 4):
        args[i] = _offset_view(args[i])
    got = ops.ssd_scan(*args, force="cuda")
    torch.cuda.synchronize()
    assert ops.ssd_scan.route_launches["wgmma"] == before + 2
    assert torch.equal(got, want)
