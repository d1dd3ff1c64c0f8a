"""The port's layer primitives and MLP against the reference's, on the CPU.

Same seeded numpy inputs through ``repro.models.layers`` /
``repro.models.mlp`` and their counterparts in ``repro_torch.models``.
float32 throughout; rtol = atol = 1e-5 for elementwise maps (same
arithmetic, possibly another libm), 1e-4 for contractions over d (another
summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import mlp as jmlp
from repro_torch.models import layers, mlp

EW = dict(rtol=1e-5, atol=1e-5)
DOT = dict(rtol=1e-4, atol=1e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _both(fn_j, fn_t, *arrays, **kw):
    want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays), **kw))
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    return got.numpy(), want


def test_rms_norm():
    rng = _rng(0)
    x = (rng.normal(size=(2, 5, 64)) * 3).astype(np.float32)
    w = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    got, want = _both(jl.rms_norm, layers.rms_norm, x, w, eps=1e-6)
    np.testing.assert_allclose(got, want, **EW)


def test_rms_norm_keeps_bf16():
    x = torch.randn(3, 16).to(torch.bfloat16)
    assert layers.rms_norm(x, torch.zeros(16)).dtype == torch.bfloat16


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    x = (_rng(1).normal(size=(4, 33)) * 40).astype(np.float32)
    got, want = _both(jl.softcap, layers.softcap, x, cap=cap)
    np.testing.assert_allclose(got, want, **EW)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("D", [16, 256])
def test_rope(fraction, D):
    rng = _rng(2)
    B, S, H = 2, 40, 3
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = (np.arange(S)[None] + np.array([[0], [4000]])).astype(np.int32)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    10000.0, fraction))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                            10000.0, fraction).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    rot = int(D * fraction) // 2 * 2
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_freqs(fraction):
    inv_j, rot_j = jl.rope_freqs(256, 10000.0, fraction)
    inv, rot = layers.rope_freqs(256, 10000.0, fraction)
    assert rot == rot_j
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=1e-6)


def test_embed_and_unembed():
    rng = _rng(3)
    V, d = 384, 32
    emb = rng.normal(size=(V, d)).astype(np.float32)
    toks = rng.integers(0, V, (2, 7)).astype(np.int32)
    h = np.array(jl.embed_tokens(jnp.asarray(emb), jnp.asarray(toks)))
    got = layers.embed_tokens(torch.from_numpy(emb),
                              torch.from_numpy(toks).long()).numpy()
    np.testing.assert_array_equal(got, h)
    for cap in (0.0, 30.0):
        want = np.asarray(jl.unembed(jnp.asarray(h), jnp.asarray(emb).T, cap))
        out = layers.unembed(torch.from_numpy(h), torch.from_numpy(emb).T,
                             cap)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want, **DOT)


@pytest.mark.parametrize("V,vocab", [(256, 256), (384, 300)],
                         ids=["unpadded", "padded"])
def test_cross_entropy(V, vocab):
    rng = _rng(4)
    logits = (rng.normal(size=(3, 5, V)) * 4).astype(np.float32)
    targets = rng.integers(0, vocab, (3, 5)).astype(np.int32)
    want = float(jl.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                  vocab))
    got = float(layers.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(targets).long(), vocab))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_mlp():
    rng = _rng(5)
    d, f = 64, 128
    t = mlp.mlp_template(d, f)
    assert {k: (s.shape, s.axes) for k, s in t.items()} == {
        k: (s.shape, s.axes) for k, s in jmlp.mlp_template(d, f).items()}
    p = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
        np.float32) for k, s in t.items()}
    h = rng.normal(size=(2, 9, d)).astype(np.float32)
    want = np.asarray(jmlp.mlp_forward({k: jnp.asarray(v)
                                        for k, v in p.items()},
                                       jnp.asarray(h)))
    got = mlp.mlp_forward({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, **DOT)
