"""The two SSD-scan routes, checked on the CPU.

``kernels.ssd_scan.route`` sends bfloat16 to the wgmma kernel
(``csrc/ssd_scan_wgmma.cu``) and float32 to the wgmma-f32 kernel
(``csrc/ssd_scan.cu``, three bf16 pieces an operand) at every head dim P
and state dim N the sources instantiate, and refuses anything else. Each
route's shared memory fits one block; the wgmma source instantiates every
(P, N) that ``check_args`` takes for bf16, and both routes need x, B and C
contiguous and 16-byte aligned (the ops wrapper makes them so). On CPU
tensors ``ops.ssd_scan`` still takes the plain version and counts nothing,
whatever the dtype. The kernels themselves run only on the card
(``tests/test_torch_ssm.py``, marked ``gpu``). ``check_args`` taking every
instantiation in both dtypes, and the f32 source instantiating it, is
held in ``tests/test_torch_ssm.py``.
"""
import re

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kernel

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("N", kernel.STATE_DIMS)
@pytest.mark.parametrize("P", kernel.HEAD_DIMS)
def test_route_by_dtype_at_every_instantiation(P, N):
    assert kernel.route(BF16, P, N) == "wgmma"
    assert kernel.route(F32, P, N) == "wgmma-f32"


@pytest.mark.parametrize("args, match", [
    ((torch.float16, 64, 128), "dtype"),
    ((torch.float64, 64, 128), "dtype"),
    ((BF16, 48, 128), "head dim"),
    ((F32, 128, 128), "head dim"),
    ((BF16, 64, 256), "state dim"),
    ((F32, 64, 8), "state dim"),
])
def test_route_refuses_the_rest(args, match):
    with pytest.raises(ValueError, match=match):
        kernel.route(*args)


@pytest.mark.parametrize("route", kernel.ROUTES)
def test_each_routes_shared_memory_fits_one_block(route):
    need = {(P, N): kernel.shared_memory_bytes(P, N, route)
            for P in kernel.HEAD_DIMS for N in kernel.STATE_DIMS}
    assert max(need.values()) == need[(64, 128)] <= kernel.SHARED_MEMORY_BUDGET
    if route == "wgmma":
        # three stages of (two x tiles, B, C), two heads' hi/lo states,
        # dt, the per-warp step weights, barriers and alignment slack
        assert need[(64, 128)] == (3 * (2 * 8192 + 2 * 16384) + 2 * 2 * 16384
                                   + 1536 + 4096 + 64 + 1024) == 219_712
    else:
        # a staging slot (f32 B and C, both heads' dt), B and C as three
        # bf16 pieces each, each head's W as three, the step vectors,
        # barriers and alignment slack; P takes no room
        assert need[(64, 128)] == (2 * 32768 + 1024 + 2 * 3 * 16384
                                   + 2 * 3 * 8192 + 2 * 1040 + 64 + 1024) \
            == 217_184
        # below N = 128 C's pieces cannot hold the two heads' parked
        # y_inter (32 KB), which takes a region of its own; P takes no room
        for N, bytes_ in ((16, 106_592), (32, 127_072), (64, 168_032),
                          (128, 217_184)):
            stage = -(-(2 * 64 * N * 4 + 512) // 1024) * 1024
            piece = -(-(64 * N * 2) // 1024) * 1024
            parked = 0 if 3 * piece >= 32768 else 32768
            assert bytes_ == (stage + 6 * piece + 6 * 8192 + 2080 + parked
                              + 64 + 1024)
            assert all(need[(P, N)] == bytes_ for P in kernel.HEAD_DIMS)
    with pytest.raises(ValueError, match="route"):
        kernel.shared_memory_bytes(64, 128, "tensor-core")


def test_the_wgmma_source_instantiates_what_check_args_takes():
    src = kernel.WGMMA_SOURCE.read_text()
    assert 'extern "C"' in src and "int ssd_scan_wgmma_fwd(" in src
    assert "ssd_scan_wgmma_error_string" in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code  # two launches must agree bitwise
    assert "constexpr int kQ = 64;" in code and kernel.CHUNK == 64
    assert f"constexpr int kStages = {kernel.STAGES};" in code
    assert f"constexpr int kHeads = {kernel.HEADS_PER_BLOCK};" in code
    for P in kernel.HEAD_DIMS:
        assert f"dispatch_n<{P}>" in code
    for N in kernel.STATE_DIMS:
        assert f"launch<P, {N}>" in code
    # every wgmma shape the kernel issues has its wrapper: C.B^T at n = 64,
    # C.state^T and W.x at n = P, the state update at n = N
    ss = set(map(int, re.findall(r"wgmma_ss<(\d+)>\(float", code)))
    rs = set(map(int, re.findall(r"wgmma_rs<(\d+)>\(float", code)))
    assert ss >= {64, *kernel.HEAD_DIMS}
    assert rs >= set(kernel.HEAD_DIMS) | set(kernel.STATE_DIMS)
    # the accurate expf, and the TMA boxes clip at S (a dimension of its own)
    assert "__expf" not in code and "cp.async.bulk.tensor.4d" in code


def test_both_sources_are_built_and_listed():
    assert kernel.SOURCES == (kernel.SOURCE, kernel.WGMMA_SOURCE,
                              kernel.BWD_SOURCE)
    assert all(s.exists() for s in kernel.SOURCES)
    assert kernel.SOURCE.name == "ssd_scan.cu"


def _args(P=16, N=16, dtype=BF16, S=5, G=2):
    x = torch.zeros(2, S, 4, P, dtype=dtype)
    dt = torch.zeros(2, S, 4, dtype=dtype)
    bc = torch.zeros(2, S, G, N, dtype=dtype)
    return [x, dt, torch.zeros(4), bc, bc.clone(), torch.zeros(4)]


@pytest.mark.parametrize("which", [0, 3, 4])
def test_check_args_wants_contiguous_x_b_c_on_the_wgmma_route(which):
    """TMA reads B and C (and x on the bf16 route; the f32 kernel reads x
    at its fragments' places in the contiguous layout): a view with
    strided rows is refused on both wgmma routes."""
    for dtype in (BF16, F32):
        args = _args(dtype=dtype)
        t = args[which]
        wide = torch.zeros(*t.shape[:-1], 2 * t.shape[-1], dtype=dtype)
        args[which] = wide[..., :t.shape[-1]]
        with pytest.raises(ValueError, match=f"contiguous on the "
                           f"{kernel.route(dtype, 16, 16)} route"):
            kernel.check_args(*args)


@pytest.mark.parametrize("which", [0, 3, 4])
def test_check_args_wants_16_byte_aligned_data_on_the_wgmma_route(which):
    """A contiguous view one element into its buffer (2 bytes off in bf16,
    4 in f32) is refused on both routes."""
    for dtype in (BF16, F32):
        args = _args(dtype=dtype)
        t = args[which]
        flat = torch.zeros(t.numel() + 1, dtype=dtype)
        args[which] = flat[1:].view(t.shape)
        with pytest.raises(ValueError, match="aligned"):
            kernel.check_args(*args)


def test_ops_on_cpu_takes_the_plain_version_and_counts_nothing_in_bf16():
    """bf16 CPU tensors, which would take the wgmma route on the card
    (f32: ``tests/test_torch_ssm.py``)."""
    dtype = BF16
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 70, 2, 16, generator=gen).to(dtype)
    dt = (torch.rand(1, 70, 2, generator=gen) * 0.1).to(dtype)
    A = -torch.rand(2, generator=gen) - 1.0
    Bm = torch.randn(1, 70, 1, 16, generator=gen).to(dtype)
    Cm = torch.randn(1, 70, 1, 16, generator=gen).to(dtype)
    before = ops.ssd_scan.launches
    routes = dict(ops.ssd_scan.route_launches)
    got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=32)
    assert torch.equal(got, ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=32))
    assert got.dtype == dtype
    assert ops.ssd_scan.launches == before
    assert ops.ssd_scan.route_launches == routes
    assert set(routes) == set(kernel.ROUTES)
