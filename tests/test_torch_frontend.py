"""The vision frontend (internvl2-26b) against the reference's, on the CPU.

The reference's vlm frontend is a stub: ``frontend_embeds`` (B, F, d),
precomputed patch embeddings, are concatenated ahead of the token
embeddings (``repro/models/transformer.py:120-121``), the loss skips their
F positions (``:225-227``) and prefill takes them from the batch
(``repro/models/model.py:75-88``). internvl2-26b is held at its reduced
config (F = 8, width 64) and at width 256 with its published 48 heads of
128 over 8 kv heads, in float32, with the reference's weights carried into
the port by ``params.from_numpy``: the forward's F + S logits, the prefill
cache of F + S positions, the loss, ``serve`` against the reference's
prefill + decode at positions F + P + i, all within rtol = atol = 2e-4 (the
tolerance of ``tests/test_models.py``'s decode-vs-forward test), greedy
tokens identical. ``input_specs`` must give the reference's shapes and the
torch counterparts of its dtypes for every arch of the port and every
shape. The ``gpu`` test serves the same model on the card through the flash
kernel; jax is imported only in the fixture the CPU tests use.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs, reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import Model, input_specs, params as port_params
from repro_torch.models import transformer
from repro_torch.models.layers import cross_entropy

RTOL = ATOL = 2e-4
ARCH = "internvl2-26b"
LAYOUTS = ["reduced", "heads"]


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import Model as JaxModel
    from repro.models import input_specs as jax_input_specs
    from repro.models import transformer as jax_transformer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Model=JaxModel,
        input_specs=jax_input_specs, transformer=jax_transformer)


def _at_layout(cfg, layout):
    """internvl2's reduced config, or at width 256 with its 48 heads of 128
    over 8 kv heads (a GQA group of 6)."""
    if layout == "reduced":
        return cfg
    return dataclasses.replace(cfg, d_model=256, num_heads=48,
                               num_kv_heads=8, head_dim=128)


_MODELS = {}


def _models(J, layout):
    """(port cfg, jax model, jax params, port model, port params)."""
    if layout not in _MODELS:
        jcfg = _at_layout(J.reduced_config(J.get_config(ARCH)), layout)
        jm = J.Model(jcfg, param_dtype=J.jnp.float32)
        jp = jm.init(J.jax.random.PRNGKey(0))
        cfg = _at_layout(reduced_config(get_config(ARCH)), layout)
        pm = Model(cfg, device="cpu", param_dtype=torch.float32)
        pp = port_params.from_numpy(J.jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _MODELS[layout] = (cfg, jm, jp, pm, pp)
    return _MODELS[layout]


def _batch(cfg, B, S, seed=0):
    """tokens and targets (B, S) int32 and embeddings (B, F, d) f32, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32)
    return toks, targets, embeds


def _torch(*arrays):
    return [torch.from_numpy(a).long() if a.dtype == np.int32
            else torch.from_numpy(a) for a in arrays]


def test_internvl2_has_the_vision_stub():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.frontend, cfg.frontend_tokens) == ("vlm",
                                                               "vision", 256)
    assert reduced_config(cfg).frontend_tokens == 8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_with_frontend_matches_reference(J, layout):
    """Logits over all F + S positions, the frontend's included."""
    cfg, jm, jp, pm, pp = _models(J, layout)
    toks, _, embeds = _batch(cfg, 2, 12)
    want, _, _ = J.transformer.forward(jp, J.jnp.asarray(toks), jm.cfg,
                                       frontend_embeds=J.jnp.asarray(embeds),
                                       remat="none")
    t, e = _torch(toks, embeds)
    got, cache = transformer.forward(pp, t, cfg, frontend_embeds=e)
    assert cache is None
    assert got.shape == (2, cfg.frontend_tokens + 12, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_frontend_embeds_are_cast_to_the_activations_dtype(J):
    """bf16 parameters: the f32 embeddings join the bf16 activations, as the
    reference casts them, and the text positions see them."""
    cfg = reduced_config(get_config(ARCH))
    model = Model(cfg, device="cpu")
    params = model.init(0)
    toks, _, embeds = _batch(cfg, 1, 6)
    t, e = _torch(toks, embeds)
    a, _ = transformer.forward(params, t, cfg, frontend_embeds=e)
    b, _ = transformer.forward(params, t, cfg, frontend_embeds=e.bfloat16())
    assert torch.equal(a, b)
    c, _ = transformer.forward(params, t, cfg, frontend_embeds=-e)
    assert not torch.equal(a[:, -1], c[:, -1])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_prefill_cache_holds_the_frontend_positions(J, layout):
    """The cache holds F + S positions, equal to the reference's; the
    logits are the last text position's, the forward's last row."""
    cfg, jm, jp, pm, pp = _models(J, layout)
    toks, _, embeds = _batch(cfg, 2, 10, seed=1)
    jl, jcache = jm.prefill(jp, {"tokens": J.jnp.asarray(toks),
                                 "frontend_embeds": J.jnp.asarray(embeds)})
    t, e = _torch(toks, embeds)
    logits, cache = pm.prefill(pp, {"tokens": t, "frontend_embeds": e})
    F = cfg.frontend_tokens
    for name in ("k", "v"):
        assert cache[name].shape == (cfg.num_layers, 2, F + 10,
                                     cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    full, _ = transformer.forward(pp, t, cfg, frontend_embeds=e)
    torch.testing.assert_close(logits, full[:, -1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loss_with_frontend_matches_reference(J, layout):
    """The loss and its cross entropy, f32, with embeddings in the batch."""
    cfg, jm, jp, pm, pp = _models(J, layout)
    toks, targets, embeds = _batch(cfg, 2, 12, seed=2)
    jb = {"tokens": J.jnp.asarray(toks), "targets": J.jnp.asarray(targets),
          "frontend_embeds": J.jnp.asarray(embeds)}
    want, wm = J.transformer.loss_fn(jp, jb, jm.cfg, remat="none")
    t, tg, e = _torch(toks, targets, embeds)
    got, gm = transformer.loss_fn(pp, {"tokens": t, "targets": tg,
                                       "frontend_embeds": e}, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(gm["ce"]), float(wm["ce"]), rtol=RTOL,
                               atol=ATOL)


def test_loss_skips_the_frontend_positions(J):
    """The cross entropy reads the text positions' logits only."""
    cfg, jm, jp, pm, pp = _models(J, "reduced")
    toks, targets, embeds = _batch(cfg, 2, 12, seed=3)
    t, tg, e = _torch(toks, targets, embeds)
    loss, m = pm.loss(pp, {"tokens": t, "targets": tg, "frontend_embeds": e})
    logits, _ = transformer.forward(pp, t, cfg, frontend_embeds=e)
    want = cross_entropy(logits[:, cfg.frontend_tokens:], tg, cfg.vocab_size)
    assert torch.equal(m["ce"], want)
    assert torch.equal(loss, m["ce"])  # no auxiliary loss


def test_frontend_changes_the_loss(J):
    """The counterpart of the reference's
    ``test_vlm_frontend_stub_changes_loss``: negated patches give another
    loss in both packages, each the reference's."""
    cfg, jm, jp, pm, pp = _models(J, "reduced")
    toks, targets, _ = _batch(cfg, 2, 16, seed=4)
    embeds = 0.02 * np.ones((2, cfg.frontend_tokens, cfg.d_model),
                            np.float32)
    losses = []
    for sign in (1.0, -1.0):
        jb = {"tokens": J.jnp.asarray(toks), "targets": J.jnp.asarray(targets),
              "frontend_embeds": J.jnp.asarray(sign * embeds)}
        t, tg, e = _torch(toks, targets, sign * embeds)
        got, _ = pm.loss(pp, {"tokens": t, "targets": tg,
                              "frontend_embeds": e})
        want, _ = jm.loss(jp, jb)
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=ATOL)
        losses.append(float(got))
    assert losses[0] != losses[1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_serve_with_frontend_matches_reference_prefill_and_decode(J, layout):
    """``serve`` with embeddings against the reference's prefill followed
    by decode at positions F + P + i (its serve CLI never serves a vlm):
    identical greedy tokens, the prefill logits, and every decode step's
    logits of the port's own prefill + decode fed the reference's tokens."""
    cfg, jm, jp, pm, pp = _models(J, layout)
    jnp = J.jnp
    B, P, G = 2, 10, 8
    F = cfg.frontend_tokens
    toks, _, embeds = _batch(cfg, B, P, seed=5)
    jl, jpre = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                               "frontend_embeds": jnp.asarray(embeds)})
    jcache = {n: jnp.zeros(jpre[n].shape[:2] + (F + P + G,)
                           + jpre[n].shape[3:], jnp.float32)
              .at[:, :, :F + P].set(jpre[n]) for n in ("k", "v")}
    jdecode = J.jax.jit(jm.decode)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    want, steps = [np.asarray(tok)], []
    for i in range(G - 1):
        step, jcache = jdecode(jp, jcache, tok[:, None],
                               jnp.full((B,), F + P + i, jnp.int32))
        steps.append(np.asarray(step))
        tok = jnp.argmax(step, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    want = np.stack(want, axis=1)

    t, e = _torch(toks, embeds)
    tokens, logits = port_serve.serve(pm, pp, t, G, frontend_embeds=e)
    np.testing.assert_array_equal(tokens.numpy(), want)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    # the decode steps' logits: the port's prefill, then decode at F + P + i
    # fed the reference's tokens
    _, pre = pm.prefill(pp, {"tokens": t, "frontend_embeds": e})
    cache = pm.cache_template(B, F + P + G)
    for n in ("k", "v"):
        cache[n][:, :, :F + P] = pre[n]
    for i in range(G - 1):
        got, cache = pm.decode(pp, cache, torch.from_numpy(want[:, i:i + 1])
                               .long(), torch.full((B,), F + P + i))
        np.testing.assert_allclose(got.numpy(), steps[i], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")


def test_serve_refuses_a_frontend_without_a_prefill_cache():
    cfg = reduced_config(get_config("mamba2-130m"))
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    with pytest.raises(ValueError, match="frontend"):
        port_serve.serve(model, model.init(0), torch.zeros(1, 4).long(), 2,
                         frontend_embeds=torch.zeros(1, 2, cfg.d_model))


def test_serve_main_draws_frontend_embeddings(capsys):
    tokens = port_serve.main(["--arch", ARCH, "--device", "cpu", "--batch",
                              "2", "--prompt_len", "6", "--gen_len", "3"])
    assert tokens.shape == (2, 3)
    assert "frontend=8 prompt=6" in capsys.readouterr().out


_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def _spec_tree(tree):
    """{key: (shape, dtype name)} of a nested dict of specs or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _spec_tree(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(J, arch, shape):
    """Every input of every (arch, shape) cell: the reference's shapes, the
    torch counterparts of its dtypes, on the meta device (nothing
    allocated, the full-size decode caches included)."""
    jcfg, cfg = J.get_config(arch), get_config(arch)
    sc = SHAPES[shape]
    want = J.input_specs(jcfg, sc, J.Model(jcfg))
    got = input_specs(cfg, sc, Model(cfg, device="cpu"))
    assert _spec_tree(got) == _spec_tree(want)
    leaves = [got[k] for k in got if k != "cache"] + list(
        got.get("cache", {}).values())
    assert all(t.device.type == "meta" for t in leaves)
    assert all(t.dtype in _DTYPES.values() for t in leaves)
    assert ("frontend_embeds" in got) == (arch == ARCH and
                                          sc.kind != "decode")


def test_input_specs_decode_needs_the_model():
    cfg = get_config(ARCH)
    with pytest.raises(ValueError, match="model"):
        input_specs(cfg, SHAPES["decode_32k"])


@pytest.mark.gpu
def test_frontend_serving_through_the_kernel_on_the_card():
    """internvl2-26b at width 256 with its 48 heads of 128 over 8 kv heads,
    f32, on the card: ``serve`` with embeddings through the flash kernel
    (one launch a layer, in the prefill only) against ``force="ref"``:
    the prefill logits within 2e-4 and the greedy tokens identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_frontend.py)")
    from repro_torch.kernels import ops
    cfg = _at_layout(reduced_config(get_config(ARCH)), "heads")
    model = Model(cfg, param_dtype=torch.float32)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 200), generator=gen,
                            device="cuda")
    embeds = torch.randn(2, cfg.frontend_tokens, cfg.d_model, generator=gen,
                         device="cuda")
    before = ops.flash_attention.launches
    tok_k, logits_k = port_serve.serve(model, params, prompts, 8,
                                       frontend_embeds=embeds)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches - before == cfg.num_layers
    tok_r, logits_r = port_serve.serve(model, params, prompts, 8, force="ref",
                                       frontend_embeds=embeds)
    torch.testing.assert_close(logits_k, logits_r, rtol=RTOL, atol=ATOL)
    assert torch.equal(tok_k, tok_r)
