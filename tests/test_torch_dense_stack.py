"""The port's other dense-stack configs against the reference's, on the CPU.

phi3-mini-3.8b, minitron-8b, chatglm3-6b (half-dim rotary), musicgen-large
(the ``audio`` family: codec ids as tokens) and internvl2-26b (the ``vlm``
family, 8 stand-in frontend embeddings at its reduced config) run the dense
stack in both packages. Each is held at two sizes in float32, 2 layers and
vocab 256 both:

  * ``reduced``: the reference's ``reduced_config`` (width 64, 4 q heads
    padded to 16, 2 kv heads, head_dim 16);
  * ``heads``: width 256 with the published head layout (phi3-mini 32 heads
    of 96; minitron-8b 32 of 128 over 8 kv heads; chatglm3-6b 32 of 128 over
    2, a GQA group of 16; musicgen-large 32 of 64; internvl2-26b 48 of 128
    over 8, a group of 6).

The reference's weights are carried into the port with
``params.from_numpy``; templates must be equal, prefill logits and caches,
8 decode steps' logits and the ``serve`` prefill logits within rtol = atol =
2e-4 (the tolerance of the reference's decode-vs-forward test,
``tests/test_models.py``), and greedy tokens identical. The reference's
``serve`` CLI never serves a frontend, so ``serve`` is held to the
reference's ``Model.prefill`` followed by ``Model.decode``, composed here.
The port's attention takes its plain version (CPU tensors); the
reference's runs as its own CPU tests run it (``ops.flash_attention``'s
plain path off the TPU). The ``gpu`` test holds the flash kernel at GQA
groups 6 and 16 against its plain version on the card; jax is imported
only in the fixture the CPU tests use.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as port_serve
from repro_torch.models import Model, attention, params as port_params
from repro_torch.models import transformer
from repro_torch.testing.tolerances import half_ulp_excess

RTOL = ATOL = 2e-4
F32_NOISE = 2.0 ** -18  # chip_smoke.py's bf16 rounding rule, over max|v|
ARCHS = ["phi3-mini-3.8b", "minitron-8b", "chatglm3-6b", "musicgen-large",
         "internvl2-26b"]
LAYOUTS = ["reduced", "heads"]
HEADS_WIDTH = 256
# (num_heads, num_kv_heads, head_dim) as published
PUBLISHED_HEADS = {"phi3-mini-3.8b": (32, 32, 96), "minitron-8b": (32, 8, 128),
                   "chatglm3-6b": (32, 2, 128), "musicgen-large": (32, 32, 64),
                   "internvl2-26b": (48, 8, 128)}
# the reference's count_params of each full template (its ArchConfig's
# analytic param_count leaves out the final norm's d_model weights)
FULL_PARAMS = {"phi3-mini-3.8b": 3_821_472_768, "minitron-8b": 9_882_046_464,
               "chatglm3-6b": 6_243_454_976, "musicgen-large": 3_229_812_736,
               "internvl2-26b": 19_862_722_560}


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import Model as JaxModel
    from repro.models import params as jax_params
    from repro.models import transformer as jax_transformer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Model=JaxModel,
        params=jax_params, transformer=jax_transformer)


def _at_layout(cfg, arch, layout):
    """`cfg` (either package's reduced config) at the test's layout."""
    if layout == "reduced":
        return cfg
    H, KV, D = PUBLISHED_HEADS[arch]
    return dataclasses.replace(cfg, d_model=HEADS_WIDTH, num_heads=H,
                               num_kv_heads=KV, head_dim=D)


_CASES = {}


def _case(J, arch, layout):
    """(port cfg, jax model, jax params, port model, port params), built
    once a session for each (arch, layout)."""
    key = (arch, layout)
    if key not in _CASES:
        jcfg = _at_layout(J.reduced_config(J.get_config(arch)), arch, layout)
        jm = J.Model(jcfg, param_dtype=J.jnp.float32)
        jp = jm.init(J.jax.random.PRNGKey(0))
        cfg = _at_layout(reduced_config(get_config(arch)), arch, layout)
        pm = Model(cfg, device="cpu", param_dtype=torch.float32)
        pp = port_params.from_numpy(J.jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _CASES[key] = (cfg, jm, jp, pm, pp)
    return _CASES[key]


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _frontend(cfg, B, seed=1):
    """Stand-in patch embeddings (B, F, d) for a config with a frontend,
    else None."""
    if not cfg.frontend_tokens:
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32)


def _batches(J, toks, embeds):
    """The same batch for the reference (jnp) and the port (torch)."""
    jb = {"tokens": J.jnp.asarray(toks)}
    pb = {"tokens": torch.from_numpy(toks).long()}
    if embeds is not None:
        jb["frontend_embeds"] = J.jnp.asarray(embeds)
        pb["frontend_embeds"] = torch.from_numpy(embeds)
    return jb, pb


def _spec_fields(J, template):
    leaves = J.jax.tree_util.tree_flatten_with_path(
        template, is_leaf=J.params.is_spec)[0]
    return {J.jax.tree_util.keystr(path): (leaf.shape, leaf.axes, leaf.init,
                                           leaf.scale)
            for path, leaf in leaves}


def _port_fields(template, prefix=""):
    out = {}
    for k in sorted(template):
        v, key = template[k], f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_port_fields(v, key))
        else:
            out[key] = (v.shape, v.axes, v.init, v.scale)
    return out


@pytest.mark.parametrize("size", ["reduced", "heads", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_template_matches_reference(J, arch, size):
    """Names, shapes, axes, initializers and count equal the reference's,
    at the full size too (nothing is initialised)."""
    jcfg, cfg = J.get_config(arch), get_config(arch)
    if size != "full":
        jcfg = _at_layout(J.reduced_config(jcfg), arch, size)
        cfg = _at_layout(reduced_config(cfg), arch, size)
    jt = J.transformer.model_template(jcfg)
    pt = transformer.model_template(cfg)
    assert _port_fields(pt) == _spec_fields(J, jt)
    assert port_params.count_params(pt) == J.params.count_params(jt)
    assert sorted(pt["layers"]) == ["attn", "ln1", "ln2", "mlp"]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_matches_reference(J, arch):
    """Each full config's parameter count: the port's Model and config
    against the reference's count_params and config, and the published
    sizes pinned; no q head is padded at full size."""
    cfg, jcfg = get_config(arch), J.get_config(arch)
    n = Model(cfg, device="cpu").param_count()
    assert n == J.Model(jcfg).param_count() == FULL_PARAMS[arch]
    assert cfg.param_count() == jcfg.param_count() == n - cfg.d_model
    assert attention.padded_heads(cfg) == cfg.num_heads
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == \
        PUBLISHED_HEADS[arch]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(J, arch, layout):
    """Last-position logits and the k/v caches of both layers (F + 20
    positions with a frontend)."""
    cfg, jm, jp, pm, pp = _case(J, arch, layout)
    toks = _tokens(2, 20, cfg.vocab_size, seed=3)
    embeds = _frontend(cfg, 2)
    jb, pb = _batches(J, toks, embeds)
    jl, jcache = jm.prefill(jp, jb)
    logits, cache = pm.prefill(pp, pb)
    assert logits.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    S = 20 + cfg.frontend_tokens
    for name in ("k", "v"):
        assert cache[name].shape == (2, 2, S, cfg.num_kv_heads,
                                     cfg.resolved_head_dim)
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(J, arch, layout):
    """8 decode steps token by token from an empty cache of 12 positions:
    every step's logits, then the caches."""
    cfg, jm, jp, pm, pp = _case(J, arch, layout)
    jnp = J.jnp
    B, S = 2, 12
    toks = _tokens(B, 8, cfg.vocab_size, seed=5)
    jcache = J.jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            jm.cache_template(B, S, jnp.float32))
    cache = pm.cache_template(B, S)
    jdecode = J.jax.jit(jm.decode)
    for i in range(8):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.full((B,), i, jnp.int32))
        logits, cache = pm.decode(pp, cache,
                                  torch.from_numpy(toks[:, i:i + 1]).long(),
                                  torch.full((B,), i, dtype=torch.long))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=RTOL,
                                   atol=ATOL)


def reference_serve(J, jm, jp, jb, gen_len):
    """The reference's greedy serving of a batch, composed by hand:
    ``Model.prefill``, its cache copied into one of F + P + gen_len
    positions, then ``Model.decode`` at positions F + P + i. Returns
    (tokens (B, gen_len), the prefill's logits, every decode step's
    logits)."""
    jnp = J.jnp
    logits, pre = jm.prefill(jp, jb)
    L, B, P = pre["k"].shape[:3]
    cache = {}
    for name in ("k", "v"):
        shape = (L, B, P + gen_len) + pre[name].shape[3:]
        cache[name] = jnp.zeros(shape, pre[name].dtype).at[:, :, :P].set(
            pre[name])
    jdecode = J.jax.jit(jm.decode)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out, steps = [np.asarray(tok)], []
    for i in range(gen_len - 1):
        step, cache = jdecode(jp, cache, tok[:, None],
                              jnp.full((B,), P + i, jnp.int32))
        steps.append(np.asarray(step))
        tok = jnp.argmax(step, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.stack(out, axis=1), np.asarray(logits), steps


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_reference_greedy(J, arch, layout):
    """``serve`` (prefill, the cache copy, 7 decode steps) against the
    reference's prefill + decode: 8 identical greedy tokens and the prefill
    logits within the tolerance."""
    cfg, jm, jp, pm, pp = _case(J, arch, layout)
    B, P, G = 2, 16, 8
    prompts = _tokens(B, P, cfg.vocab_size, seed=7)
    embeds = _frontend(cfg, B, seed=8)
    jb, pb = _batches(J, prompts, embeds)
    want, want_logits, _ = reference_serve(J, jm, jp, jb, G)
    tokens, logits = port_serve.serve(pm, pp, pb["tokens"], G,
                                      frontend_embeds=pb.get(
                                          "frontend_embeds"))
    assert tokens.shape == (B, G)
    np.testing.assert_array_equal(tokens.numpy(), want)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=RTOL,
                               atol=ATOL)


def test_chatglm_rotates_half_the_head_dim_in_decode_too(J):
    """chatglm3's reduced and heads configs keep the name prefix that picks
    the half-dim rotary; a full rotary would move the decode logits."""
    cfg, jm, jp, pm, pp = _case(J, "chatglm3-6b", "heads")
    assert cfg.name.startswith("chatglm")
    cache = pm.cache_template(1, 4)
    toks = torch.tensor([[3], [5]]).view(1, 2)
    for i in range(2):
        got, cache = pm.decode(pp, cache, toks[:, i:i + 1],
                               torch.full((1,), i, dtype=torch.long))
    full = Model(dataclasses.replace(cfg, name="full-rotary"), device="cpu",
                 param_dtype=torch.float32)
    cache = full.cache_template(1, 4)
    for i in range(2):
        other, cache = full.decode(pp, cache, toks[:, i:i + 1],
                                   torch.full((1,), i, dtype=torch.long))
    assert not torch.allclose(got, other, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "internvl2-26b"])
def test_greedy_runs_over_the_padded_vocabulary(arch):
    """phi3-mini's 32 064 and internvl2's 92 553 pad to 32 128 and 92 672;
    prefill logits cover the padded entries and greedy argmax reads them,
    as the reference's does."""
    cfg = get_config(arch)
    assert cfg.padded_vocab == {"phi3-mini-3.8b": 32_128,
                                "internvl2-26b": 92_672}[arch]
    small = dataclasses.replace(reduced_config(cfg), vocab_size=250)
    model = Model(small, device="cpu", param_dtype=torch.float32)
    params = model.init(0)
    # real columns give logits of 0; padded column 250 is v, 251 is -v, so
    # one of the two wins every argmax
    v = params["unembed"][:, 250].clone()
    params["unembed"].zero_()
    params["unembed"][:, 250], params["unembed"][:, 251] = v, -v
    embeds = torch.zeros(1, small.frontend_tokens, small.d_model) \
        if small.frontend_tokens else None
    tokens, logits = port_serve.serve(model, params, torch.tensor([[1, 2]]),
                                      3, frontend_embeds=embeds)
    assert logits.shape == (1, 256)
    assert set(tokens[0].tolist()) <= {250, 251}


@pytest.mark.gpu
def test_flash_kernel_at_groups_6_and_16_on_the_card():
    """The flash kernel at internvl2-26b's GQA group of 6 (48 q heads over 8
    kv heads) and chatglm3-6b's 16 (32 over 2), D = 128, unaligned S: f32
    (the wgmma-f32 route) within rtol = atol = 2e-5 of the plain version,
    bf16 (the wgmma route) to chip_smoke.py's rounding rule, which P
    rounded to bf16 and scores rounded to bf16 must both fail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_dense_stack.py)")
    rng = np.random.default_rng(0)
    for B, H, KV, S, D in ((2, 48, 8, 200, 128), (2, 32, 2, 200, 128),
                           (1, 48, 8, 333, 64), (1, 32, 2, 190, 96)):
        q = torch.from_numpy(rng.normal(size=(B, S, H, D)) * 0.5).float()
        k = torch.from_numpy(rng.normal(size=(B, S, KV, D)) * 0.5).float()
        v = torch.from_numpy(rng.normal(size=(B, S, KV, D))).float()
        f = [t.cuda() for t in (q, k, v)]
        got = ops.flash_attention(*f, force="cuda")
        want = ops.flash_attention(*f, force="ref")
        assert flash_kernel.route(torch.float32, D) == "wgmma-f32"
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        b = [t.to(torch.bfloat16) for t in f]
        out = ops.flash_attention(*b, force="cuda")
        fb = [t.float() for t in b]
        ex = half_ulp_excess(
            ref.attention_ref(*fb), float(fb[2].abs().max()), kernel=out,
            p_bf16=ref.attention_ref(*fb, p_split=1).to(torch.bfloat16),
            scores_bf16=ref.attention_naive(*b))
        assert ex["kernel"] <= F32_NOISE, (B, H, KV, S, D, ex)
        assert min(ex["p_bf16"], ex["scores_bf16"]) > F32_NOISE, ex
