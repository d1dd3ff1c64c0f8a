"""The port's flash-attention module against the reference's.

On the CPU the port's plain version (``ref.attention_ref``, which the
wrapper ``ops.flash_attention`` takes for CPU tensors) is held against the
reference's textbook oracle ``ref.attention_naive`` and its Pallas kernel
in interpret mode, on the cases of ``tests/test_kernels.py`` (3 shapes x
{causal, window 64, softcap 30, non-causal}) at the same rtol = atol =
2e-5, bf16 at 0.05, an unaligned S = 200 and the decode offset.

Two faults of the reference are pinned here, and the port does not share
them: its ``ops.flash_attention`` pads Sk to 128 and passes the padded
length as the kernel's ``sk``, so with ``causal=False`` the zero keys enter
the softmax (the port's unaligned non-causal case is held against
``attention_naive`` only); and its ``attention_ref`` returns NaN for a row
whose first chunk the window masks entirely.

Two kernels take the card's calls, both on the tensor cores: bf16 the
wgmma one, f32 the wgmma-f32 one (three-piece bf16 splits; ``route``); the
tests here pin that choice and each layout's shared memory. The one test that needs the card (marked ``gpu``) holds both
kernels against the plain version there, bf16 also to the rounding rule of
``chip_smoke.py``; it decides inside its body whether to skip, and this
module imports jax only inside the tests that compare with the JAX
package.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ops, ref
from repro_torch.testing.tolerances import half_ulp_excess

RTOL = ATOL = 2e-5
F32_NOISE = 2.0 ** -18  # chip_smoke.py's bf16 rounding rule, over max|v|
# the reference's test shapes, then phi3-mini's head dim 96 and zamba2-7b's
# 112 (H = KV, as zamba2's shared attention has it)
SHAPES = [(1, 4, 4, 128, 64), (2, 4, 2, 256, 64), (1, 8, 2, 128, 128),
          (1, 4, 2, 128, 96), (2, 4, 4, 128, 112)]
OPTS = [dict(causal=True), dict(causal=True, window=64),
        dict(causal=True, softcap=30.0), dict(causal=False)]
OPT_IDS = ["causal", "window64", "softcap30", "noncausal"]


def _qkv(B, H, KV, Sq, D, seed=0, Sk=None, dtype=np.float32):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D), scaled as tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    q = rng.normal(size=(B, Sq, H, D)) * 0.5
    k = rng.normal(size=(B, Sk, KV, D)) * 0.5
    v = rng.normal(size=(B, Sk, KV, D))
    return [a.astype(dtype) for a in (q, k, v)]


def _port(args, **opts):
    out = ops.flash_attention(*(torch.from_numpy(a) for a in args), **opts)
    return out.float().numpy()


def _jax_naive(args, **opts):
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    return np.asarray(jax_ref.attention_naive(
        *(jnp.asarray(a) for a in args), **opts), dtype=np.float32)


@pytest.mark.parametrize("B,H,KV,S,D", SHAPES)
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_plain_matches_jax_naive(B, H, KV, S, D, opts):
    args = _qkv(B, H, KV, S, D)
    np.testing.assert_allclose(_port(args, **opts), _jax_naive(args, **opts),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,H,KV,S,D", SHAPES)
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_plain_matches_pallas_interpret(B, H, KV, S, D, opts):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_pallas
    args = _qkv(B, H, KV, S, D, seed=1)
    q, k, v = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in args)
    want = flash_attention_pallas(q, k, v, bq=64, bk=64, interpret=True,
                                  **opts).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_port(args, **opts), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_plain_bf16_matches_reference():
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_pallas
    B, H, KV, S, D = 1, 2, 2, 128, 64
    tb = [torch.from_numpy(a).to(torch.bfloat16)
          for a in _qkv(B, H, KV, S, D, seed=2)]
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    got = ops.flash_attention(*tb, causal=True)
    assert got.dtype == torch.bfloat16
    q, k, v = (a.transpose(0, 2, 1, 3) for a in jb)
    pallas = flash_attention_pallas(q, k, v, bq=64, bk=64, causal=True,
                                    interpret=True).transpose(0, 2, 1, 3)
    for want in (np.asarray(pallas, np.float32), _jax_naive(jb,
                                                            causal=True)):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                                   atol=0.05)


@pytest.mark.parametrize("opts", [dict(causal=True),
                                  dict(causal=True, window=160, softcap=30.0)],
                         ids=["causal", "window160-softcap30"])
def test_plain_unaligned_matches_jax_ref_and_naive(opts):
    """S = 200 with chunk 64, as tests/test_kernels.py holds attention_ref
    (a window of 160 keeps every row's first chunk non-empty, which the
    reference's attention_ref needs)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    args = _qkv(2, 4, 2, 200, 32, seed=3)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in args), chunk=64,
                            **opts).numpy()
    want = jax_ref.attention_ref(*(jnp.asarray(a) for a in args), chunk=64,
                                 **opts)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _jax_naive(args, **opts), rtol=RTOL,
                               atol=ATOL)


def test_plain_unaligned_noncausal_matches_naive():
    """Held against attention_naive only: the reference's ops wrapper pads
    Sk = 200 to 256 and its kernel then lets the 56 zero keys in."""
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    args = _qkv(2, 4, 2, 200, 64, seed=4)
    got = _port(args, causal=False)
    np.testing.assert_allclose(got, _jax_naive(args, causal=False),
                               rtol=RTOL, atol=ATOL)
    padded = np.asarray(jax_ops.flash_attention(
        *(jnp.asarray(a) for a in args), causal=False, force="pallas"))
    assert np.abs(padded - got).max() > 1e-2  # the reference's fault


def test_plain_window_past_the_first_chunk_matches_naive():
    """A row whose first chunk the window masks entirely: the reference's
    attention_ref gives NaN there; the port's plain version does not."""
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    args = _qkv(1, 2, 2, 200, 16, seed=5)
    opts = dict(causal=True, window=16)
    got = ref.attention_ref(*(torch.from_numpy(a) for a in args), chunk=64,
                            **opts).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_naive(args, **opts), rtol=RTOL,
                               atol=ATOL)
    jref = np.asarray(jax_ref.attention_ref(*(jnp.asarray(a) for a in args),
                                            chunk=64, **opts))
    assert np.isnan(jref).any()  # the reference's fault


def test_plain_decode_offset():
    """q_offset reproduces the decode position semantics: the last row of
    a causal pass equals one query at q_offset = S - 1."""
    B, S, H, D = 1, 96, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, H, H, S, D, seed=6))
    full = ops.flash_attention(q, k, v, causal=True)
    last = ops.flash_attention(q[:, -1:], k, v, causal=True, q_offset=S - 1)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-5, atol=1e-6)
    want = _jax_naive([a.numpy() for a in (q[:, -1:], k, v)], causal=True,
                      q_offset=S - 1)
    np.testing.assert_allclose(last.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_naive_matches_jax_naive():
    args = _qkv(2, 4, 2, 64, 16, seed=7)
    opts = dict(causal=True, window=20, softcap=30.0)
    got = ref.attention_naive(*(torch.from_numpy(a) for a in args), **opts)
    np.testing.assert_allclose(got.numpy(), _jax_naive(args, **opts),
                               rtol=RTOL, atol=ATOL)


def test_auto_on_cpu_takes_the_plain_version_and_counts_nothing():
    args = [torch.from_numpy(a) for a in _qkv(1, 4, 2, 70, 16, seed=8)]
    before = ops.flash_attention.launches
    got = ops.flash_attention(*args, window=20)
    want = ref.attention_ref(*args, window=20)
    assert torch.equal(got, want)
    assert torch.equal(ops.flash_attention(*args, window=20, force="ref"),
                       want)
    assert ops.flash_attention.launches == before


def test_force_cuda_on_cpu_tensors_raises():
    args = [torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 16)]
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(*args, force="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.flash_attention_cuda(*args)


def test_unknown_force_raises():
    args = [torch.from_numpy(a) for a in _qkv(1, 2, 2, 8, 16)]
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention(*args, force="pallas")


def _bad_args(case):
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 8, 16))
    opts = {}
    if case == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed_dtype":
        v = v.to(torch.bfloat16)
    elif case == "head_dim":
        q, k, v = (torch.zeros(*t.shape[:3], 32) for t in (q, k, v))
    elif case == "gqa":
        q = torch.zeros(2, 8, 3, 16)
    elif case == "rank":
        q = q[0]
    elif case == "batch":
        k, v = k[:1], v[:1]
    elif case == "kv_shape":
        v = v[:, :4]
    elif case == "contiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "empty":
        q = q[:, :0]
    elif case == "window":
        opts = dict(window=-1)
    elif case == "q_offset":
        opts = dict(q_offset=-2)
    elif case == "softcap":
        opts = dict(softcap=-1.0)
    elif case == "misaligned":  # TMA needs 16-byte aligned data
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    return q, k, v, opts


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim", "gqa",
                                  "rank", "batch", "kv_shape", "contiguous",
                                  "empty", "window", "q_offset", "softcap",
                                  "misaligned"])
def test_check_args_refuses(case):
    q, k, v, opts = _bad_args(case)
    with pytest.raises(ValueError, match="flash_attention"):
        kernel.check_args(q, k, v, **opts)


@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_check_args_takes_every_head_dim_in_both_dtypes(D):
    for dtype in kernel.DTYPES:
        q = torch.zeros(1, 3, 4, D, dtype=dtype)
        k = torch.zeros(1, 5, 2, D, dtype=dtype)
        kernel.check_args(q, k, k.clone(), window=4, softcap=50.0,
                          q_offset=7)


def test_shared_memory_budget_holds_at_head_dim_256():
    """Both layouts at gemma2's head dim, pinned: on the wgmma-f32 route f32
    Q for 128 rows, a staging slot of 16 f32 keys of K and V and their bf16
    piece tiles; bf16 Q and a two-stage K/V ring on the wgmma route."""
    need = kernel.shared_memory_bytes(256, "wgmma-f32")
    assert kernel.f32_block_n(256) == 16
    assert need == (2 * 64 * 256 * 4 + 2 * 16 * 256 * 4
                    + 2 * 3 * 16 * 256 * 2 + 64 + 1024) == 214_080
    wgmma = kernel.shared_memory_bytes(256, "wgmma")
    assert wgmma == 2 * (128 * 256 + 2 * 2 * 64 * 256) + 64 + 1024 == 197_696
    assert max(need, wgmma) <= kernel.SHARED_MEMORY_BUDGET
    assert kernel.shared_memory_bytes(16, "wgmma-f32") < need


@pytest.mark.parametrize("route", kernel.ROUTES)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_shared_memory_budget_holds_for_every_route_and_head_dim(route, D):
    need = kernel.shared_memory_bytes(D, route)
    assert 0 < need <= kernel.SHARED_MEMORY_BUDGET
    if D > min(kernel.HEAD_DIMS):
        assert kernel.shared_memory_bytes(D // 2, route) < need


@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_route_picks_wgmma_for_bf16_and_cuda_core_for_f32(D):
    """Named for the route f32 took before its tensor-core redesign: f32
    now takes ``wgmma-f32``, the name the SSD scan's and the flash
    backward's f32 routes have."""
    assert kernel.route(torch.bfloat16, D) == "wgmma"
    assert kernel.route(torch.float32, D) == "wgmma-f32"
    assert {kernel.route(t, D) for t in kernel.DTYPES} == \
        set(kernel.ROUTES)


@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_the_sources_take_every_head_dim(D):
    """Each source's switch launches D on the instantiation of the layout
    ``layout_head_dim`` names, with D as its true head dim, and has no case
    the table lacks; 96 and 112 run the 128 layout, with its shared
    memory."""
    L = kernel.layout_head_dim(D)
    for src in kernel.SOURCES:
        cases = {int(c): (int(lay), int(dt or lay)) for c, lay, dt in
                 re.findall(r"case (\d+):\s*return launch<(?:T, )?(\d+)"
                            r"(?:, (\d+))?>", src.read_text())}
        assert sorted(cases) == sorted(kernel.HEAD_DIMS), src.name
        assert cases[D] == (L, D), (src.name, D)
    assert L == (128 if D in (96, 112) else D) and L in kernel.HEAD_DIMS
    for route in kernel.ROUTES:
        assert kernel.shared_memory_bytes(D, route) == \
            kernel.shared_memory_bytes(L, route)


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="dtype"):
        kernel.route(torch.float64, 64)
    with pytest.raises(ValueError, match="head dim"):
        kernel.route(torch.bfloat16, 32)
    with pytest.raises(ValueError, match="route"):
        kernel.shared_memory_bytes(64, "tensor-core")


def test_sources_are_one_per_route():
    """One forward source per route, and the backward's (both dtypes)."""
    assert kernel.SOURCES == (kernel.SOURCE, kernel.WGMMA_SOURCE,
                              kernel.BWD_SOURCE)
    assert all(src.exists() for src in kernel.SOURCES)
    text = kernel.WGMMA_SOURCE.read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg"):
        assert needle in text


def test_library_path_is_named_by_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = kbuild.library_path(src)
    assert first.parent == kbuild.BUILD_DIR and first.name.startswith("libk_")
    assert kbuild.library_path(src) == first
    src.write_text("// two\n")
    assert kbuild.library_path(src) != first


def test_build_all_reuses_a_built_library(tmp_path, monkeypatch):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    lib = kbuild.library_path(src)
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"built")
    assert kbuild.build_all([src]) == [lib]  # no compiler is run


def test_compiler_report_keeps_registers_spills_and_warnings(tmp_path):
    lib = tmp_path / "libk_0.so"
    lib.with_name(lib.name + ".log").write_text(
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compile time = 1.0 ms\n")
    report = kbuild.compiler_report(lib)
    assert len(report) == 3
    assert "Performance Loss" in report[0] and "spill" in report[1]
    assert report[2].endswith("Used 168 registers, used 1 barriers")


def test_build_failure_raises(tmp_path, monkeypatch):
    """No nvcc on the host, or a source nvcc refuses: RuntimeError."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "bad.cu"
    src.write_text("this is not CUDA C++\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        kbuild.build_all([src])
    assert not kbuild.library_path(src).exists()


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card():
    """Kernel vs plain version on the card, causal, window, softcap,
    non-causal, unaligned S and a decode offset: every head dim (96 and 112
    zero-padded to the 128 layout inside the kernels) in f32 (the
    wgmma-f32 route; rtol = atol = 2e-5) and bf16 (the wgmma route; 1e-2,
    and the rounding rule of chip_smoke.py: each output within half a bf16
    ulp of the plain version on f32 copies plus 2^-18 max|v|, which P
    rounded to bf16 and scores rounded to bf16 must both fail); two
    launches agree bitwise and each launch is counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_flash_attention.py)")
    cases = [((2, 4, 2, 200, 64), dict(causal=True)),
             ((2, 4, 2, 200, 64), dict(causal=False)),
             ((1, 4, 4, 130, 16), dict(causal=True, window=40)),
             ((1, 8, 2, 256, 128), dict(causal=True, softcap=30.0)),
             ((1, 16, 8, 300, 256), dict(causal=True, window=100,
                                         softcap=50.0)),
             ((2, 4, 4, 200, 112), dict(causal=True)),
             ((1, 8, 2, 190, 112), dict(causal=True, window=70,
                                        softcap=30.0)),
             ((2, 4, 2, 200, 96), dict(causal=False)),
             ((1, 4, 4, 170, 96), dict(causal=True, window=50))]
    for (B, H, KV, S, D), opts in cases:
        for dtype, tol in ((np.float32, 2e-5), (np.float32, None)):
            args = [torch.from_numpy(a).cuda()
                    for a in _qkv(B, H, KV, S, D, seed=S + D)]
            if tol is None:  # the same case in bf16
                args, tol = [a.to(torch.bfloat16) for a in args], 1e-2
            before = ops.flash_attention.launches
            a = ops.flash_attention(*args, **opts)
            b = ops.flash_attention(*args, force="cuda", **opts)
            want = ops.flash_attention(*args, force="ref", **opts)
            torch.cuda.synchronize()
            assert ops.flash_attention.launches == before + 2
            assert torch.equal(a, b), (B, H, KV, S, D, opts)
            torch.testing.assert_close(a.float(), want.float(), rtol=tol,
                                       atol=tol)
            if a.dtype == torch.bfloat16:
                f = [t.float() for t in args]
                ex = half_ulp_excess(
                    ref.attention_ref(*f, **opts),
                    float(f[2].abs().max()), kernel=a,
                    p_bf16=ref.attention_ref(*f, p_split=1, **opts).to(
                        a.dtype),
                    scores_bf16=ref.attention_naive(*args, **opts))
                assert ex["kernel"] <= F32_NOISE, (B, H, KV, S, D, opts, ex)
                assert min(ex["p_bf16"], ex["scores_bf16"]) > F32_NOISE, ex
    q, k, v = (torch.from_numpy(a).cuda() for a in _qkv(1, 4, 2, 1, 64, 0,
                                                         Sk=150))
    got = ops.flash_attention(q, k, v, q_offset=149, window=64)
    want = ops.flash_attention(q, k, v, q_offset=149, window=64, force="ref")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
