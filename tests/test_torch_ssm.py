"""The port's mamba2-130m serving slice against the reference's, on the CPU.

The SSD scan first: the port's plain versions (``ref.ssd_ref``, the exact
recurrence, and ``ref.ssd_chunked_ref``, the chunked form the CUDA kernel
computes) and ``ops.ssd_scan`` on CPU tensors are held against the JAX
package's ``ref.ssd_ref``, ``models.ssm.ssd_chunked`` and
``ops.ssd_scan(force="pallas")`` (the Pallas kernel in interpret mode) at
the reference's own tolerance, rtol = atol = 1e-4 in f32, on the shapes of
``tests/test_kernels.py``, an unaligned S = 100 and G = 2. dt and A are
drawn as Mamba-2 initialises them (A = -U[1, 16], dt log-uniform in
[1e-3, 1e-1]), and one slow-decay case keeps exp(sum dt A) over a chunk
above 0.5, so the state carried across chunks matters: a version that
drops it must fail the tolerance on every case.

Then the model: reduced mamba2 (2 layers, d_model 64, 8 heads of 16,
state 16, chunk 16) in float32, the reference's weights carried into the
port with ``params.from_numpy`` after A_log and dt_bias are set in the
numpy tree as Mamba-2 initialises them (the template's A_log = 1,
dt_bias = 0 decay the state to 0 within a chunk). Module outputs, prefill
logits and decode logits are held at 2e-4, the tolerance of the
reference's decode-vs-forward test (``tests/test_models.py``).

The one test that needs the card (marked ``gpu``) holds the CUDA kernel
against the plain chunked version there; it decides inside its body
whether to skip.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kernel
from repro_torch.launch import serve as port_serve
from repro_torch.models import Model, params as port_params, ssm, transformer

RTOL = ATOL = 1e-4  # tests/test_kernels.py holds the SSD scan at 1e-4
MODEL_TOL = 2e-4
ARCH = "mamba2-130m"

# (B, S, H, P, G, N), the port's chunk, a chunk dividing S for the JAX
# package's ssd_chunked, and how dt and A are drawn
CASES = {
    "kernels-a": ((1, 64, 2, 16, 1, 16), 16, 16, "mamba2"),
    "kernels-b": ((2, 128, 4, 16, 2, 32), 32, 32, "mamba2"),
    "kernels-c": ((1, 96, 2, 32, 1, 64), 32, 32, "mamba2"),
    "unaligned-g2": ((2, 100, 4, 16, 2, 16), 32, 20, "mamba2"),
    "slow-decay": ((1, 128, 2, 16, 1, 16), 32, 32, "slow"),
}


def _ssd_inputs(shape, decay, seed=0):
    """x, dt, A, Bm, Cm, D as float32 numpy arrays. "mamba2": A = -U[1, 16]
    and dt log-uniform in [1e-3, 1e-1]; "slow": A = -U[0.5, 1] and dt
    log-uniform in [1e-3, 1e-2]."""
    B, S, H, P, G, N = shape
    rng = np.random.default_rng(seed)
    lo, hi, a_lo, a_hi = ((1e-3, 1e-1, 1.0, 16.0) if decay == "mamba2"
                          else (1e-3, 1e-2, 0.5, 1.0))
    f32 = np.float32
    return (
        (rng.normal(size=(B, S, H, P)) * 0.5).astype(f32),
        np.exp(rng.uniform(np.log(lo), np.log(hi), (B, S, H))).astype(f32),
        -rng.uniform(a_lo, a_hi, H).astype(f32),
        (rng.normal(size=(B, S, G, N)) * 0.3).astype(f32),
        (rng.normal(size=(B, S, G, N)) * 0.3).astype(f32),
        (1.0 + 0.5 * rng.normal(size=H)).astype(f32),
    )


@pytest.fixture(scope="module")
def J():
    """The JAX package, imported by the tests that compare with it and not
    at module import, so the gpu test runs where jax is not installed."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from repro.models import Model as JaxModel
    from repro.models import ssm as jax_ssm
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, ops=jax_ops, ref=jax_ref,
        Model=JaxModel, ssm=jax_ssm,
        arrays=lambda arrays: [jnp.asarray(a) for a in arrays])


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
def test_ssd_ref_matches_reference(J, case):
    shape, _, _, decay = CASES[case]
    args = _ssd_inputs(shape, decay)
    got = ref.ssd_ref(*_t(args))
    want = J.ref.ssd_ref(*J.arrays(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_ssd_chunked_ref_matches_reference(J, case):
    """Against the recurrence and the reference's chunked form (at a chunk
    dividing S: it refuses a ragged one; the port's pads it)."""
    shape, chunk, jax_chunk, decay = CASES[case]
    args = _ssd_inputs(shape, decay, seed=1)
    got = ref.ssd_chunked_ref(*_t(args), chunk=chunk).numpy()
    np.testing.assert_allclose(got, np.asarray(J.ref.ssd_ref(*J.arrays(args))),
                               rtol=RTOL, atol=ATOL)
    want = J.ssm.ssd_chunked(*J.arrays(args), chunk=jax_chunk)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_ops_ssd_scan_on_cpu_matches_pallas_interpret(J, case):
    shape, chunk, _, decay = CASES[case]
    args = _ssd_inputs(shape, decay, seed=2)
    got = ops.ssd_scan(*_t(args), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == shape[:4]
    want = J.ops.ssd_scan(*J.arrays(args), chunk=chunk, force="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_dropping_the_carried_state_fails_the_tolerance(J, case):
    """The control: the chunked SSD without the state carried across
    chunks (y_intra + D x) is far outside 1e-4 of the recurrence on these
    inputs, so the tests above can see a kernel that drops the carry."""
    shape, chunk, _, decay = CASES[case]
    x, dt, A, Bm, Cm, D = args = _ssd_inputs(shape, decay, seed=2)
    y_intra, y_inter = ref.ssd_chunk_terms(*_t(args[:5]), chunk=chunk)
    dropped = (y_intra + torch.from_numpy(D)[None, None, :, None]
               * torch.from_numpy(x)).numpy()
    want = np.asarray(J.ref.ssd_ref(*J.arrays(args)))
    excess = np.abs(dropped - want) - (ATOL + RTOL * np.abs(want))
    assert excess.max() > 10 * ATOL, excess.max()
    kept = (y_intra + y_inter).numpy() + D[None, None, :, None] * x
    np.testing.assert_allclose(kept, want, rtol=RTOL, atol=ATOL)


def test_the_slow_decay_case_carries_over_half_a_chunk():
    """exp(sum of dt A over a chunk) is above 0.5 in every chunk and head."""
    shape, chunk, _, decay = CASES["slow-decay"]
    _, dt, A, *_ = _ssd_inputs(shape, decay, seed=2)
    B, S, H = dt.shape
    per_chunk = (dt * A).reshape(B, S // chunk, chunk, H).sum(axis=2)
    assert np.exp(per_chunk).min() > 0.5


def test_the_chunk_length_changes_only_rounding():
    """The kernel runs chunks of 64, the model's plain path of 256."""
    args = _t(_ssd_inputs((1, 256, 2, 16, 1, 16), "slow", seed=3))
    want = ref.ssd_ref(*args)
    for chunk in (16, 64, 100, 256):
        got = ref.ssd_chunked_ref(*args, chunk=chunk)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _half_ulp_excess(y, oracle):
    """Largest distance of bf16 `y` to the f32 `oracle` beyond half a bf16
    ulp of the oracle, over max|oracle| (<= 0: correctly rounded)."""
    oracle = oracle.float()
    exponent = torch.frexp(oracle.abs().clamp_min(2.0 ** -126))[1]
    half_ulp = torch.exp2((exponent - 9).float())
    return float(((y.float() - oracle).abs() - half_ulp).max()) / float(
        oracle.abs().max())


def test_bf16_rounds_once_where_the_reference_ops_rounds_twice(J):
    """bf16 inputs: the port's plain version (as the reference's
    ssd_chunked) rounds the f32 result once, so each output is the f32
    value correctly rounded. The reference's ops.ssd_scan rounds the scan
    and then the sum with D x (ops.py:101-102): a fault of the reference
    (ROADMAP C) that moves outputs past half an ulp."""
    args = _ssd_inputs((1, 64, 2, 16, 1, 16), "mamba2", seed=4)
    tb = [a.to(torch.bfloat16) for a in _t(args[:5])] + [_t(args[5:])[0]]
    oracle = ref.ssd_ref(*(a.float() for a in tb))  # f32 math, same values
    port = ops.ssd_scan(*tb, chunk=16)
    assert port.dtype == torch.bfloat16
    jb = [J.jnp.asarray(t.float().numpy()).astype(J.jnp.bfloat16)
          for t in tb[:5]]
    jb.append(J.jnp.asarray(args[5]))
    chunked = torch.from_numpy(np.asarray(
        J.ssm.ssd_chunked(*jb, chunk=16), np.float32))
    twice = torch.from_numpy(np.asarray(
        J.ops.ssd_scan(*jb, chunk=16, force="pallas"), np.float32))
    noise = 2.0 ** -18
    assert _half_ulp_excess(port, oracle) <= noise
    assert _half_ulp_excess(chunked, oracle) <= noise
    assert _half_ulp_excess(twice, oracle) > 10 * noise
    assert float((twice != port.float()).float().mean()) > 0.1


def test_auto_on_cpu_takes_the_plain_version_and_counts_nothing():
    args = _t(_ssd_inputs((1, 40, 2, 16, 1, 16), "mamba2", seed=5))
    before = ops.ssd_scan.launches
    got = ops.ssd_scan(*args, chunk=16)
    assert torch.equal(got, ref.ssd_chunked_ref(*args, chunk=16))
    assert torch.equal(ops.ssd_scan(*args, chunk=16, force="ref"), got)
    assert torch.equal(ops.ssd_scan(*args[:5], chunk=16),
                       ref.ssd_chunked_ref(*args[:5], chunk=16))
    assert ops.ssd_scan.launches == before


def test_force_cuda_on_cpu_tensors_raises():
    args = _t(_ssd_inputs((1, 8, 2, 16, 1, 16), "mamba2"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ssd_scan(*args, force="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel.ssd_scan_cuda(*args)


def test_unknown_force_raises():
    args = _t(_ssd_inputs((1, 8, 2, 16, 1, 16), "mamba2"))
    with pytest.raises(ValueError, match="force"):
        ops.ssd_scan(*args, force="pallas")


def _bad_args(case):
    x, dt, A, Bm, Cm, D = _t(_ssd_inputs((2, 8, 4, 16, 2, 16), "mamba2"))
    if case == "dtype":
        x, dt, Bm, Cm = x.double(), dt.double(), Bm.double(), Cm.double()
    elif case == "mixed_dtype":
        dt = dt.to(torch.bfloat16)
    elif case == "head_dim":
        x = torch.zeros(2, 8, 4, 24)
    elif case == "state_dim":
        Bm, Cm = torch.zeros(2, 8, 2, 48), torch.zeros(2, 8, 2, 48)
    elif case == "groups":
        Bm, Cm = torch.zeros(2, 8, 3, 16), torch.zeros(2, 8, 3, 16)
    elif case == "rank":
        dt = dt[..., None]
    elif case == "dt_shape":
        dt = dt[:, :4]
    elif case == "bc_shape":
        Cm = Cm[:1]
    elif case == "strided_last_axis":
        x = torch.zeros(2, 8, 4, 32)[..., ::2]
    elif case == "empty":
        x, dt, Bm, Cm = x[:, :0], dt[:, :0], Bm[:, :0], Cm[:, :0]
    elif case == "A":
        A = A.double()
    elif case == "D":
        D = D[:2]
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "head_dim",
                                  "state_dim", "groups", "rank", "dt_shape",
                                  "bc_shape", "strided_last_axis", "empty",
                                  "A", "D"])
def test_check_args_refuses(case):
    with pytest.raises(ValueError, match="ssd_scan"):
        kernel.check_args(*_bad_args(case))


def test_check_args_takes_every_instantiation_and_strided_rows():
    """Every (P, N) in both dtypes, with dt read through its strides; the
    model's layout (views of wider activations) is refused for x, B and C
    on both routes (TMA and the f32 kernel's x reads take the contiguous
    layout), and ``ops.ssd_scan`` hands such views over as contiguous
    copies (``ops.tma_operand``)."""
    for P in kernel.HEAD_DIMS:
        for N in kernel.STATE_DIMS:
            for dtype in kernel.DTYPE_CODES:
                x = torch.zeros(2, 5, 4, P, dtype=dtype)
                dt = torch.zeros(2, 5, 4, dtype=dtype)
                bc = torch.zeros(2, 5, 2, N, dtype=dtype)
                kernel.check_args(x, dt, torch.zeros(4), bc, bc.clone(),
                                  torch.zeros(4))
                kernel.check_args(x, dt, torch.zeros(4), bc, bc, None)
                kernel.check_args(x, torch.zeros(2, 5, 8, dtype=dtype)[..., ::2],
                                  torch.zeros(4), bc, bc, None)
    wide = torch.zeros(2, 5, 4 * 16 + 2 * 16 * 2)
    x = wide[..., :64].unflatten(-1, (4, 16))
    bc = wide[..., 64:96].unflatten(-1, (2, 16))
    with pytest.raises(ValueError, match="contiguous"):
        kernel.check_args(x, wide[..., :4], torch.zeros(4), bc, bc, None)
    args = [ops.tma_operand(t) for t in (x, bc)]
    kernel.check_args(args[0], wide[..., :4], torch.zeros(4), args[1],
                      args[1], None)


def test_shared_memory_fits_every_instantiation():
    """The f32 route's layout (``Cfg`` in ``csrc/ssd_scan.cu``), the
    default of ``shared_memory_bytes``: at N = 128 the staging slot (f32
    B and C, 64 KB, and 512 bytes of dt), B and C as three bf16 pieces (96
    KB), two heads' W as three (48 KB), the step vectors, the barriers and
    the alignment slack."""
    need = kernel.shared_memory_bytes(64, 128)
    assert need == kernel.shared_memory_bytes(64, 128, "wgmma-f32")
    assert need == (65 * 1024 + 6 * 16384 + 6 * 8192 + 8 * 260 + 64 + 1024)
    assert need == 217_184 <= kernel.SHARED_MEMORY_BUDGET
    assert all(kernel.shared_memory_bytes(P, N) <= need
               for P in kernel.HEAD_DIMS for N in kernel.STATE_DIMS)


def test_the_source_instantiates_what_check_args_takes():
    """The f32 source: every (P, N) check_args takes, the chunk, heads and
    pieces the module mirrors, wgmma products fed by TMA, no atomics and
    the accurate expf."""
    src = kernel.SOURCE.read_text()
    assert 'extern "C"' in src and "int ssd_scan_fwd(" in src
    assert "ssd_scan_error_string" in src
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "constexpr int kQ = 64;" in code and kernel.CHUNK == 64
    assert f"constexpr int kHeads = {kernel.HEADS_PER_BLOCK};" in code
    assert f"constexpr int kPieces = {kernel.PIECES};" in code
    assert "atomic" not in code  # two launches must agree bitwise
    for P in kernel.HEAD_DIMS:
        assert f"dispatch_n<{P}>" in code
    for N in kernel.STATE_DIMS:
        assert f"launch<P, {N}>" in code
    assert "wgmma.mma_async" in code and "cp.async.bulk.tensor.4d" in code
    assert "setmaxnreg" in code and "__expf" not in code


# ---------------------------------------------------------------------------
# The model: reduced mamba2 against the reference
# ---------------------------------------------------------------------------
def _mamba2_numpy_params(J, jp, seed=0):
    """The reference's tree as numpy, with A_log = log U[1, 16] and dt_bias
    = softplus^-1(log-uniform [1e-3, 1e-1]) per layer and head."""
    tree = J.jax.tree.map(lambda a: np.array(a), jp)
    rng = np.random.default_rng(seed)
    lay = tree["layers"]["ssm"]
    shape = lay["A_log"].shape  # (L, nh)
    lay["A_log"] = np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    lay["dt_bias"] = np.log(np.expm1(dt0)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def reduced(J):
    """(port cfg, jax model, jax params, port model, port params)."""
    jcfg = J.reduced_config(J.get_config(ARCH))
    jm = J.Model(jcfg, param_dtype=J.jnp.float32)
    tree = _mamba2_numpy_params(J, jm.init(J.jax.random.PRNGKey(0)))
    jp = J.jax.tree.map(J.jnp.asarray, tree)
    cfg = reduced_config(get_config(ARCH))
    pm = Model(cfg, device="cpu", param_dtype=torch.float32)
    pp = port_params.from_numpy(tree, device="cpu")
    return cfg, jm, jp, pm, pp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def test_reduced_config_is_the_references(reduced):
    cfg, jm, *_ = reduced
    assert (cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk, cfg.num_layers) == (128, 8, 16, 16, 16, 2)
    assert cfg.param_count() == jm.cfg.param_count()


def test_full_mamba2_size(J):
    """The template holds 128.96 M parameters (~0.52 GB in f32), as the
    reference's Model.param_count; ArchConfig.param_count's closed form
    gives 128.94 M in both packages."""
    cfg = get_config(ARCH)
    count = port_params.count_params(transformer.model_template(cfg))
    assert count == J.Model(J.get_config(ARCH)).param_count() == 128_958_912
    assert cfg.param_count() == J.get_config(ARCH).param_count() \
        == 128_939_712
    assert (cfg.ssm_inner, cfg.ssm_heads, cfg.padded_vocab) == (1536, 24,
                                                                50304)


def test_causal_conv_matches_reference(J):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    want = J.ssm._causal_conv(J.jnp.asarray(x), J.jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_ssm_forward_matches_reference(J, reduced):
    """One layer's block on 64 positions: four chunks of 16 carry state."""
    cfg, jm, jp, pm, pp = reduced
    h = (np.random.default_rng(7).normal(size=(2, 64, cfg.d_model))
         * 0.5).astype(np.float32)
    for i in range(cfg.num_layers):
        want = J.ssm.ssm_forward(_layer(jp["layers"]["ssm"], i),
                                   J.jnp.asarray(h), jm.cfg, chunk=16)
        got = ssm.ssm_forward(transformer.layer_params(pp["layers"], i)["ssm"],
                              torch.from_numpy(h), cfg, chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)


def test_ssd_chunked_keeps_the_references_contract():
    args = _t(_ssd_inputs((1, 40, 2, 16, 1, 16), "mamba2"))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssm.ssd_chunked(*args, chunk=16)
    torch.testing.assert_close(ssm.ssd_chunked(*args, chunk=20),
                               ref.ssd_chunked_ref(*args, chunk=20))


def test_ssm_decode_step_matches_reference_and_updates_in_place(J, reduced):
    cfg, jm, jp, pm, pp = reduced
    rng = np.random.default_rng(8)
    B = 2
    h = (rng.normal(size=(B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    one = ssm.ssm_cache_template(cfg, B)
    state = rng.normal(size=one["state"].shape).astype(np.float32)
    conv = rng.normal(size=one["conv"].shape).astype(np.float32)
    want, wcache = J.ssm.ssm_decode_step(
        _layer(jp["layers"]["ssm"], 1), J.jnp.asarray(h), jm.cfg,
        {"state": J.jnp.asarray(state), "conv": J.jnp.asarray(conv)})
    cache = {"state": torch.from_numpy(state.copy()),
             "conv": torch.from_numpy(conv.copy())}
    tensors = dict(cache)
    got, gcache = ssm.ssm_decode_step(
        transformer.layer_params(pp["layers"], 1)["ssm"], torch.from_numpy(h),
        cfg, cache)
    assert all(gcache[k] is tensors[k] for k in tensors)  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for k in ("state", "conv"):
        np.testing.assert_allclose(gcache[k].numpy(), np.asarray(wcache[k]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)


def test_cache_template_is_f32_and_shaped_as_the_reference(J, reduced):
    cfg, jm, jp, pm, pp = reduced
    cache = Model(cfg, device="cpu").cache_template(3, 50,
                                                    dtype=torch.bfloat16)
    want = jm.cache_template(3, 50)
    for k in ("state", "conv"):
        assert tuple(cache[k].shape) == tuple(want[k].shape)
        assert cache[k].dtype == torch.float32
        assert want[k].dtype == J.jnp.float32
        assert torch.count_nonzero(cache[k]) == 0


def test_prefill_matches_reference(J, reduced):
    """64 prompt tokens: four chunks of 16 in each layer."""
    cfg, jm, jp, pm, pp = reduced
    toks = _tokens(2, 64, cfg.vocab_size)
    jl, jcache = jm.prefill(jp, {"tokens": J.jnp.asarray(toks)})
    logits, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()})
    assert cache is None and jcache is None
    assert logits.shape == (2, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def _jax_decode_loop(J, jm, jp, toks):
    """The reference's decode over given tokens (B, n) from an empty
    cache: the logits of every step, (B, n, Vp)."""
    B, n = toks.shape
    jcache = J.jax.tree.map(lambda s: J.jnp.zeros(s.shape, s.dtype),
                          jm.cache_template(B, n))
    jdecode = J.jax.jit(jm.decode)
    out = []
    for i in range(n):
        logits, jcache = jdecode(jp, jcache, J.jnp.asarray(toks[:, i:i + 1]),
                                 J.jnp.full((B,), i, J.jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out, axis=1)


def test_decode_matches_reference(J, reduced):
    """A 32-token prompt fed through decode (warm_up), then 8 decode steps
    fed given tokens: the logits of every step, not greedy tokens alone
    (random weights repeat one token)."""
    cfg, jm, jp, pm, pp = reduced
    B, P, n = 2, 32, 8
    toks = _tokens(B, P + n, cfg.vocab_size, seed=5)
    want = _jax_decode_loop(J, jm, jp, toks)
    t = torch.from_numpy(toks).long()
    last, cache = port_serve.warm_up(pm, pp, t[:, :P], pm.cache_template(B, P))
    np.testing.assert_allclose(last.numpy(), want[:, P - 1], rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for i in range(n):
        logits, cache = pm.decode(pp, cache, t[:, P + i:P + i + 1],
                                  torch.full((B,), P + i))
        np.testing.assert_allclose(logits.numpy(), want[:, P + i],
                                   rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=f"step {i}")


def test_prefill_matches_its_own_decode_warm_up(reduced):
    """The scan against the recurrence in the port alone: the prefill's
    last logits equal the decode warm-up's over the same 64 tokens."""
    cfg, jm, jp, pm, pp = reduced
    t = torch.from_numpy(_tokens(2, 64, cfg.vocab_size, seed=6)).long()
    want, _ = pm.prefill(pp, {"tokens": t})
    got, _ = port_serve.warm_up(pm, pp, t, pm.cache_template(2, 64))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_serve_tokens_equal_reference_greedy_decode(J, reduced):
    """serve (prefill for the first token, warm-up, decode) against the
    reference's token-by-token greedy decode, as its serve CLI runs it."""
    cfg, jm, jp, pm, pp = reduced
    B, P, G = 2, 32, 8
    prompts = _tokens(B, P, cfg.vocab_size, seed=7)
    jcache = J.jax.tree.map(lambda s: J.jnp.zeros(s.shape, s.dtype),
                          jm.cache_template(B, P + G))
    jdecode = J.jax.jit(jm.decode)
    toks = J.jnp.asarray(prompts[:, :1])
    gen = []
    for i in range(P + G - 1):
        logits, jcache = jdecode(jp, jcache, toks,
                                 J.jnp.full((B,), i, J.jnp.int32))
        if i + 1 < P:
            toks = J.jnp.asarray(prompts[:, i + 1:i + 2])
        else:
            toks = J.jnp.argmax(logits, -1).astype(J.jnp.int32)[:, None]
            gen.append(np.asarray(toks[:, 0]))
        if i == P - 1:  # the step that reads the last prompt token
            j_prefill_logits = np.asarray(logits)
    tokens, logits = port_serve.serve(pm, pp,
                                      torch.from_numpy(prompts).long(), G)
    assert tokens.shape == (B, G)
    np.testing.assert_array_equal(tokens.numpy(), np.stack(gen, axis=1))
    np.testing.assert_allclose(logits.numpy(), j_prefill_logits,
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_serve_one_token_is_the_prefill_argmax(reduced):
    cfg, jm, jp, pm, pp = reduced
    prompts = torch.from_numpy(_tokens(2, 16, cfg.vocab_size, seed=9)).long()
    tokens, logits = port_serve.serve(pm, pp, prompts, 1)
    want, _ = pm.prefill(pp, {"tokens": prompts})
    assert torch.equal(logits, want)
    assert torch.equal(tokens[:, 0], want.argmax(-1))
    longer, _ = port_serve.serve(pm, pp, prompts, 3)
    assert torch.equal(longer[:, :1], tokens)


def test_make_serve_steps_threads_force_to_the_scan(reduced):
    cfg, jm, jp, pm, pp = reduced
    toks = torch.from_numpy(_tokens(1, 16, cfg.vocab_size, seed=8)).long()
    prefill, _ = port_serve.make_serve_steps(pm, force="ref")
    a, _ = prefill(pp, {"tokens": toks})
    b, _ = pm.prefill(pp, {"tokens": toks})
    assert torch.equal(a, b)
    prefill, _ = port_serve.make_serve_steps(pm, force="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill(pp, {"tokens": toks})


def test_bf16_model_serves_finite_logits():
    cfg = reduced_config(get_config(ARCH))
    m = Model(cfg, device="cpu")
    p = m.init(0)
    assert p["layers"]["ssm"]["wx"].dtype == torch.bfloat16
    prompts = torch.from_numpy(_tokens(2, 32, cfg.vocab_size, seed=10)).long()
    tokens, logits = port_serve.serve(m, p, prompts, 4)
    assert tokens.shape == (2, 4) and bool(torch.isfinite(logits).all())


def test_serve_main_runs_mamba2_on_the_cpu(capsys):
    tokens = port_serve.main(["--arch", "mamba2-130m", "--device", "cpu",
                              "--batch", "2", "--prompt_len", "16",
                              "--gen_len", "4"])
    assert tokens.shape == (2, 4)
    assert "served batch=2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_kernel_matches_plain_on_the_card():
    """Kernel vs the plain chunked version on the card, at every
    instantiated head and state dim, G = 1 and 2, 3 heads a group,
    ragged S, D and no D,
    and a strided x in f32 and in bf16. f32 takes the wgmma-f32 route and
    is held at 1e-4, and within 1e-5 of max|y| off the f64 oracle (the
    plain chunked SSD on f64 copies); bf16 takes the wgmma route and is
    held to the
    rounding rule of chip_smoke.py: each output within half a bf16 ulp of
    the f32 result (the plain chunked SSD on f32 copies of the inputs),
    plus 2^-18 max|y|. Two launches agree bitwise, and each launch is
    counted once, under the route that ``route`` picks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_ssm.py)")

    def launched(args, D, dtype):
        """Two launches through ops.ssd_scan: the output, after checking
        the counts went to the routed kernel."""
        P, N = args[0].shape[-1], args[3].shape[-1]
        kind = kernel.route(dtype, P, N)
        assert kind == ("wgmma" if dtype == torch.bfloat16 else "wgmma-f32")
        before = ops.ssd_scan.launches
        routes = dict(ops.ssd_scan.route_launches)
        a = ops.ssd_scan(*args, D)
        b = ops.ssd_scan(*args, D, force="cuda")
        torch.cuda.synchronize()
        assert ops.ssd_scan.launches == before + 2
        assert ops.ssd_scan.route_launches[kind] == routes[kind] + 2
        assert sum(ops.ssd_scan.route_launches.values()) == \
            sum(routes.values()) + 2
        assert torch.equal(a, b), (P, N, dtype)
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        return a

    def held(got, args, D):
        if got.dtype == torch.float32:
            want = ops.ssd_scan(*args, D, chunk=32, force="ref")
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            f = [a.double() for a in args]
            y_intra, y_inter = ref.ssd_chunk_terms(*f, chunk=kernel.CHUNK)
            oracle = y_intra + y_inter
            if D is not None:
                oracle = oracle + D.double()[None, None, :, None] * f[0]
            gap = (got.double() - oracle).abs().max() / oracle.abs().max()
            assert float(gap) <= 1e-5, (tuple(got.shape), float(gap))
            return
        f = [a.float() for a in args]
        y_intra, y_inter = ref.ssd_chunk_terms(*f, chunk=kernel.CHUNK)
        oracle = y_intra + y_inter
        if D is not None:
            oracle = oracle + D[None, None, :, None] * f[0]
        ex = _half_ulp_excess(got, oracle)
        assert ex <= 2.0 ** -18, (tuple(got.shape), ex)

    cases = [(P, N) for P in kernel.HEAD_DIMS for N in kernel.STATE_DIMS]
    shapes = [(2, 100 + 37 * i, 4, P, 2 if i % 2 else 1, N)
              for i, (P, N) in enumerate(cases)]
    # 3 heads a group: the block of the last pair has one head, and its
    # second consumer warpgroup computes on zeros through every barrier
    shapes.append((1, 333, 6, 32, 2, 32))
    for i, shape in enumerate(shapes):
        args = [a.cuda() for a in _t(_ssd_inputs(shape, "mamba2", seed=i))]
        for dtype in (torch.float32, torch.bfloat16):
            a5 = [a.to(dtype) for a in args[:5]]
            a5[2] = args[2]
            D = args[5] if i % 3 else None
            held(launched(a5, D, dtype), a5, D)
    # views of wider activations, as a model's projection gives them: made
    # contiguous for TMA on both routes; S = 300 leaves a ragged last chunk
    wide = torch.randn(2, 300, 4 * 64 + 2 * 128 + 4, device="cuda") * 0.3
    A = -torch.linspace(1.0, 8.0, 4, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        w = wide.to(dtype)
        x = w[..., :256].unflatten(-1, (4, 64))
        Bm = w[..., 256:384].unflatten(-1, (1, 128))
        Cm = w[..., 384:512].unflatten(-1, (1, 128))
        dt = torch.nn.functional.softplus(w[..., 512:].float() - 4.0).to(dtype)
        assert not x.is_contiguous() and not Bm.is_contiguous()
        args = [x, dt, A, Bm, Cm]
        held(launched(args, None, dtype), args, None)
