"""The P split of the bf16 flash-attention kernel, emulated on the CPU.

The wgmma kernel (``csrc/flash_attention_wgmma.cu``) cannot run here, but
its one numerical departure from the f32 CUDA-core kernel can: it takes
P.V as p_hi.V + p_lo.V with p_hi = bf16(p) and p_lo = bf16(p - p_hi), two
bf16 tensor-core products into one f32 accumulator.
``ref.attention_ref(p_split=2)`` computes that; ``p_split=1`` rounds P once
to bf16, as a textbook tensor-core kernel does.

On bf16 inputs from a numpy seed, at small unaligned shapes with gemma2's
GQA and head dim among them, the split must hold the rounding rule of
``chip_smoke.py``: each output within half a bf16 ulp of the f32 result,
plus 2^-18 max|v|. P rounded once must fail it. The f32 result is
``attention_ref`` on f32 copies of the inputs, itself held to the JAX
package's textbook attention.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.testing.tolerances import half_ulp_excess

F32_NOISE = 2.0 ** -18  # chip_smoke.py's bf16 rounding rule, over max|v|
SHAPES = [(1, 4, 2, 200, 64), (1, 4, 4, 261, 16), (1, 8, 4, 230, 128),
          (1, 16, 8, 333, 256)]  # (B, H, KV, Sk, D)
OPTS = [dict(causal=True), dict(causal=True, window=96, softcap=50.0),
        dict(causal=True, softcap=30.0, q_offset=77)]
OPT_IDS = ["causal", "window96-softcap50", "softcap30-q_offset77"]


def _inputs(B, H, KV, Sk, D, q_offset=0, seed=0):
    """bf16 q (B, Sk - q_offset, H, D) and k/v (B, Sk, KV, D): a prefill
    chunk whose first query sits at q_offset."""
    rng = np.random.default_rng(seed + Sk + D)
    q = rng.normal(size=(B, Sk - q_offset, H, D))
    k = rng.normal(size=(B, Sk, KV, D))
    v = rng.normal(size=(B, Sk, KV, D))
    return [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in (q, k, v)]


def _excess(shape, opts, **splits):
    """half_ulp_excess of attention_ref at each named p_split, rounded to
    bf16, against attention_ref on f32 copies, over max|v|."""
    q, k, v = _inputs(*shape, q_offset=opts.get("q_offset", 0))
    f = [t.float() for t in (q, k, v)]
    oracle = ref.attention_ref(*f, **opts)
    outs = {name: ref.attention_ref(*f, p_split=n, **opts).to(torch.bfloat16)
            for name, n in splits.items()}
    return half_ulp_excess(oracle, float(f[2].abs().max()), **outs)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[-1]}")
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_split_p_holds_the_rounding_rule(shape, opts):
    ex = _excess(shape, opts, split=2, f32_p=0)
    assert ex["split"] <= F32_NOISE, ex
    assert ex["f32_p"] <= F32_NOISE, ex


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[-1]}")
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_p_in_bf16_control_fails_the_rounding_rule(shape, opts):
    ex = _excess(shape, opts, p_bf16=1)
    assert ex["p_bf16"] > F32_NOISE, ex


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"D{s[-1]}")
@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
def test_f32_oracle_matches_jax_naive(shape, opts):
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    q, k, v = (t.float() for t in _inputs(*shape,
                                          q_offset=opts.get("q_offset", 0)))
    got = ref.attention_ref(q, k, v, **opts).numpy()
    want = jax_ref.attention_naive(*(jnp.asarray(t.numpy())
                                     for t in (q, k, v)), **opts)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=2e-5,
                               atol=2e-5)


def test_split_p_residuals():
    """P rounded once to bf16 (8 significant bits) is within 2^-8 p of p;
    p_hi + p_lo keeps 2^-8 of that, within 2^-16 p; p_split=0 is P."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.exp(-rng.exponential(4.0, size=100_000))
                         .astype(np.float32))
    two, one = ref.split_p(p, 2), ref.split_p(p, 1)
    assert float(((two - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((one - p).abs() / p).max()) <= 2.0 ** -8
    assert float(((two - p).abs() / p).max()) < \
        float(((one - p).abs() / p).max()) / 100
    assert torch.equal(ref.split_p(p, 0), p)


def test_p_split_zero_is_the_default_and_others_raise():
    q, k, v = (t.float() for t in _inputs(1, 4, 2, 70, 16))
    opts = dict(window=20, softcap=30.0)
    assert torch.equal(ref.attention_ref(q, k, v, p_split=0, **opts),
                       ref.attention_ref(q, k, v, **opts))
    with pytest.raises(ValueError, match="p_split"):
        ref.attention_ref(q, k, v, p_split=3)
