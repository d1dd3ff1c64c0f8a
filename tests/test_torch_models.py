"""The port's gemma2-9b serving slice against the reference's, on the CPU.

Reduced gemma2-9b (2 layers: one local with window 8, one global; 4 q heads
padded to 16, 2 kv heads, head_dim 16) in float32. The reference's weights
are carried into the port with ``params.from_numpy``, so both run the same
numbers; prefill and decode logits and the caches are held to rtol = atol =
2e-4, the tolerance of the reference's decode-vs-forward test
(``tests/test_models.py``), and greedy tokens must be identical. The port's
attention takes its plain version here (CPU tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro.models import attention as jax_attention
from repro.models import params as jax_params
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import Model, attention, params as port_params
from repro_torch.models import transformer

RTOL = ATOL = 2e-4
ARCH = "gemma2-9b"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reduced():
    """(port cfg, jax model, jax params, port model, port params)."""
    jcfg = jax_reduced_config(jax_get_config(ARCH))
    jm = JaxModel(jcfg, param_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config(ARCH))
    pm = Model(cfg, device="cpu", param_dtype=torch.float32)
    pp = port_params.from_numpy(_np_tree(jp), device="cpu")
    return cfg, jm, jp, pm, pp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _flat_specs(template, is_leaf, fields):
    leaves = jax.tree_util.tree_flatten_with_path(template,
                                                  is_leaf=is_leaf)[0]
    return {jax.tree_util.keystr(path): tuple(getattr(leaf, f)
                                              for f in fields)
            for path, leaf in leaves}


def _port_flat(template, fields, prefix=""):
    out = {}
    for k in sorted(template):
        v = template[k]
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_port_flat(v, fields, key))
        else:
            out[key] = tuple(getattr(v, f) for f in fields)
    return out


@pytest.mark.parametrize("arch,reduce",
                         [(ARCH, True), (ARCH, False),
                          ("mamba2-130m", True), ("mamba2-130m", False),
                          ("zamba2-7b", True), ("zamba2-7b", False),
                          ("arctic-480b", True), ("arctic-480b", False),
                          ("kimi-k2-1t-a32b", True),
                          ("kimi-k2-1t-a32b", False)],
                         ids=["reduced", "full", "mamba2-reduced",
                              "mamba2-full", "zamba2-reduced", "zamba2-full",
                              "arctic-reduced", "arctic-full",
                              "kimi-reduced", "kimi-full"])
def test_template_matches_reference(arch, reduce):
    """Names, shapes, axes, initializers and count equal the reference's,
    for the full gemma2-9b, mamba2-130m, zamba2-7b, arctic-480b and kimi-k2
    templates too (nothing is initialised); mamba2's tree is {embed,
    final_norm, layers: {ln, ssm: 13 leaves}}, zamba2's adds unembed and
    the shared block; an MoE layer holds {attn, ln1, ln2, moe} (arctic's
    moe with its dense residual MLP)."""
    from repro.models import transformer as jax_transformer
    jcfg = jax_get_config(arch)
    cfg = get_config(arch)
    if reduce:
        jcfg, cfg = jax_reduced_config(jcfg), reduced_config(cfg)
    fields = ("shape", "axes", "init", "scale")
    jt = jax_transformer.model_template(jcfg)
    pt = transformer.model_template(cfg)
    assert _port_flat(pt, fields) == _flat_specs(jt, jax_params.is_spec,
                                                 fields)
    assert port_params.count_params(pt) == jax_params.count_params(jt)
    assert Model(cfg, device="cpu").param_count() == \
        JaxModel(jcfg).param_count()
    if cfg.family == "ssm":
        assert sorted(pt) == ["embed", "final_norm", "layers"]
        assert sorted(pt["layers"]) == ["ln", "ssm"]
        assert len(pt["layers"]["ssm"]) == 13
    if cfg.family == "hybrid":
        assert sorted(pt) == ["embed", "final_norm", "layers", "shared",
                              "unembed"]
        assert sorted(pt["layers"]) == ["ln", "ssm"]
        assert sorted(pt["shared"]) == ["attn", "ln1", "ln2", "mlp"]
    if cfg.family == "moe":
        assert sorted(pt["layers"]) == ["attn", "ln1", "ln2", "moe"]
        assert sorted(pt["layers"]["moe"]) == (
            ["dense", "router", "wd", "wg", "wu"] if cfg.moe_dense_residual
            else ["router", "wd", "wg", "wu"])


def test_full_gemma2_size():
    cfg = get_config(ARCH)
    n = transformer.model_template(cfg)
    count = port_params.count_params(n)
    assert count == 9_241_705_984  # ~18.5 GB in bf16
    assert attention.padded_heads(cfg) == cfg.num_heads == 16  # no padding


def test_init_follows_the_reference_rule():
    cfg = reduced_config(get_config(ARCH))
    m = Model(cfg, device="cpu", param_dtype=torch.float32)
    p = m.init(0)
    assert torch.equal(m.init(0)["embed"], p["embed"])  # seeded
    assert all(torch.count_nonzero(p["layers"][k]) == 0
               for k in ("ln1", "ln2", "ln1post", "ln2post"))
    assert torch.count_nonzero(p["final_norm"]) == 0
    assert abs(float(p["embed"].std()) - 1.0) < 0.05
    # fan-in of a stacked (L, d, H, hd) weight is d * H: every axis but the
    # last, the layers axis left out
    wq = p["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) * (cfg.d_model * 16) ** 0.5 - 1.0) < 0.05
    wd = p["layers"]["mlp"]["wd"]
    assert abs(float(wd.std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    # padded heads (4 real of 16, 2 kv groups of 8) have zero wo rows
    mask = attention.head_mask(cfg)
    wo = p["layers"]["attn"]["wo"]
    assert int(mask.sum()) == cfg.num_heads
    assert torch.count_nonzero(wo[:, mask == 0]) == 0
    assert torch.count_nonzero(wo[:, mask == 1]) == wo[:, mask == 1].numel()
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_attention.head_mask(
            jax_reduced_config(jax_get_config(ARCH)))))


def test_init_dtype_and_device():
    cfg = reduced_config(get_config(ARCH))
    p = Model(cfg, device="cpu").init(1)
    leaves = port_params.tree_leaves(p)
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu"
               for t in leaves)


def test_from_numpy_keeps_values_and_casts():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones(4, np.float32)}}
    got = port_params.from_numpy(tree, device="cpu")
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert got["b"]["c"].dtype == torch.float32
    assert port_params.from_numpy(tree, "cpu", torch.bfloat16)["a"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("window", [0, 8])
def test_attn_forward_matches_reference(reduced, window):
    cfg, jm, jp, pm, pp = reduced
    jcfg = jm.cfg
    rng = np.random.default_rng(3)
    B, S = 2, 24
    h = (rng.normal(size=(B, S, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want, (wk, wv) = jax_attention.attn_forward(jl, jnp.asarray(h), jcfg,
                                                jnp.asarray(pos),
                                                window=window)
    pl = transformer.layer_params(pp["layers"], 0)["attn"]
    got, (k, v) = attention.attn_forward(pl, torch.from_numpy(h), cfg,
                                         torch.from_numpy(pos).long(),
                                         window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(wk), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attn_heads_matches_reference(reduced, window):
    cfg, jm, jp, pm, pp = reduced
    rng = np.random.default_rng(4)
    B, S, KV, hd = 2, 20, cfg.num_kv_heads, cfg.resolved_head_dim
    h = (rng.normal(size=(B, 1, cfg.d_model)) * 0.5).astype(np.float32)
    ck = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    cv = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.full((B,), 13, np.int32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    want, (wk, wv) = jax_attention.decode_attn_heads(
        jl, jnp.asarray(h), jm.cfg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), window=window)
    pl = transformer.layer_params(pp["layers"], 1)["attn"]
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = attention.decode_attn_heads(
        pl, torch.from_numpy(h), cfg, tk, tv, torch.from_numpy(pos).long(),
        window=window)
    assert gk is tk and gv is tv  # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)


def test_prefill_matches_reference(reduced):
    """Logits and the k/v caches of both layers; the prompt (24 tokens) is
    past the local layer's window of 8."""
    cfg, jm, jp, pm, pp = reduced
    toks = _tokens(2, 24, cfg.vocab_size)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    logits, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()})
    assert logits.shape == (2, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=RTOL,
                                   atol=ATOL)


def test_decode_matches_reference(reduced):
    """Token-by-token decode from an empty cache, 12 steps: past the window
    of 8, so the local layer's mask decides the later steps."""
    cfg, jm, jp, pm, pp = reduced
    B, S = 2, 16
    toks = _tokens(B, S, cfg.vocab_size, seed=5)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_template(B, S, jnp.float32))
    cache = pm.cache_template(B, S)
    assert cache["k"].dtype == torch.float32
    jdecode = jax.jit(jm.decode)
    for i in range(12):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, i:i + 1]),
                             jnp.full((B,), i, jnp.int32))
        logits, cache = pm.decode(pp, cache,
                                  torch.from_numpy(toks[:, i:i + 1]).long(),
                                  torch.full((B,), i, dtype=torch.long))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=RTOL, atol=ATOL)


def test_prefill_then_decode_matches_full_forward(reduced):
    """The port against itself: decoding token P after a P-token prefill
    gives the logits a (P+1)-token prefill gives at its last position."""
    cfg, jm, jp, pm, pp = reduced
    toks = torch.from_numpy(_tokens(2, 21, cfg.vocab_size, seed=6)).long()
    P = 20
    _, pre = pm.prefill(pp, {"tokens": toks[:, :P]})
    cache = pm.cache_template(2, P + 1)
    cache["k"][:, :, :P] = pre["k"]
    cache["v"][:, :, :P] = pre["v"]
    got, _ = pm.decode(pp, cache, toks[:, P:], torch.full((2,), P))
    want, _ = pm.prefill(pp, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_serve_tokens_equal_reference_greedy_decode(reduced):
    """serve (prefill + decode) against the reference's token-by-token
    greedy decode through the prompt (32 tokens, past the window of 8), as
    its serve CLI runs it: the generated tokens must be identical."""
    cfg, jm, jp, pm, pp = reduced
    B, P, G = 2, 32, 8
    prompts = _tokens(B, P, cfg.vocab_size, seed=7)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          jm.cache_template(B, P + G, jnp.float32))
    jdecode = jax.jit(jm.decode)
    toks = jnp.asarray(prompts[:, :1])
    gen = []
    for i in range(P + G - 1):
        logits, jcache = jdecode(jp, jcache, toks, jnp.full((B,), i,
                                                            jnp.int32))
        if i + 1 < P:
            toks = jnp.asarray(prompts[:, i + 1:i + 2])
        else:
            toks = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            gen.append(np.asarray(toks[:, 0]))
        if i == P - 1:  # the step that reads the last prompt token
            j_prefill_logits = np.asarray(logits)
    tokens, logits = port_serve.serve(pm, pp,
                                      torch.from_numpy(prompts).long(), G)
    assert tokens.shape == (B, G)
    np.testing.assert_array_equal(tokens.numpy(), np.stack(gen, axis=1))
    np.testing.assert_allclose(logits.numpy(), j_prefill_logits, rtol=RTOL,
                               atol=ATOL)


def test_make_serve_steps_threads_force(reduced):
    cfg, jm, jp, pm, pp = reduced
    toks = torch.from_numpy(_tokens(1, 10, cfg.vocab_size, seed=8)).long()
    prefill, decode = port_serve.make_serve_steps(pm, force="ref")
    a, _ = prefill(pp, {"tokens": toks})
    b, _ = pm.prefill(pp, {"tokens": toks})
    assert torch.equal(a, b)
    prefill, _ = port_serve.make_serve_steps(pm, force="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill(pp, {"tokens": toks})


def test_serve_one_token_is_the_prefill_argmax(reduced):
    """gen_len = 1 runs no decode step: its token is the prefill's argmax,
    and it is the first token of a longer generation."""
    cfg, jm, jp, pm, pp = reduced
    prompts = torch.from_numpy(_tokens(2, 6, cfg.vocab_size, seed=9)).long()
    tokens, logits = port_serve.serve(pm, pp, prompts, 1)
    want, _ = pm.prefill(pp, {"tokens": prompts})
    assert tokens.shape == (2, 1)
    assert torch.equal(logits, want)
    assert torch.equal(tokens[:, 0], want.argmax(-1))
    longer, _ = port_serve.serve(pm, pp, prompts, 3)
    assert torch.equal(longer[:, :1], tokens)


def test_serve_refuses_empty_generation(reduced):
    cfg, jm, jp, pm, pp = reduced
    prompts = torch.from_numpy(_tokens(1, 6, cfg.vocab_size, seed=9)).long()
    with pytest.raises(ValueError, match="gen_len"):
        port_serve.serve(pm, pp, prompts, 0)


def test_serve_main_runs_on_the_cpu(capsys):
    tokens = port_serve.main(["--device", "cpu", "--batch", "2",
                              "--prompt_len", "12", "--gen_len", "4"])
    assert tokens.shape == (2, 4)
    assert "served batch=2" in capsys.readouterr().out


def test_model_defaults_to_the_card():
    cfg = reduced_config(get_config(ARCH))
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            port_params.from_numpy({"a": np.zeros(2, np.float32)})


@pytest.mark.parametrize("change", [None,
                                    dict(family="hybrid"),
                                    dict(num_experts=8, experts_per_token=2)],
                         ids=["ssm", "hybrid", "moe"])
def test_unported_families_raise(change):
    """Every family is ported now: the ssm, hybrid and MoE cases build
    reduced mamba2, reduced zamba2 and reduced arctic-480b (with its
    dense residual), and none raises."""
    if change is None:
        cfg = reduced_config(get_config("mamba2-130m"))
        model = Model(cfg, device="cpu")
        assert model.cfg.family == "ssm" and "ssm" in model.template["layers"]
        return
    if change.get("family") == "hybrid":
        cfg = reduced_config(get_config("zamba2-7b"))
        model = Model(cfg, device="cpu")
        assert model.cfg.family == "hybrid"
        assert "ssm" in model.template["layers"]
        assert "attn" in model.template["shared"]
        return
    cfg = reduced_config(get_config("arctic-480b"))
    assert (cfg.num_experts, cfg.experts_per_token) == (
        change["num_experts"], change["experts_per_token"])
    model = Model(cfg, device="cpu")
    assert model.cfg.family == "moe"
    assert "moe" in model.template["layers"]
    assert "mlp" not in model.template["layers"]
    assert "dense" in model.template["layers"]["moe"]


def test_registry_holds_the_ported_archs_only():
    assert list_archs() == ["arctic-480b", "chatglm3-6b", "gemma2-9b",
                            "internvl2-26b", "kimi-k2-1t-a32b",
                            "mamba2-130m", "minitron-8b", "musicgen-large",
                            "phi3-mini-3.8b", "zamba2-7b"]
    assert get_config("gemma2_9b") is get_config("gemma2-9b")
    assert get_config("mamba2_130m") is get_config("mamba2-130m")
    assert get_config("zamba2_7b") is get_config("zamba2-7b")
    assert get_config("phi3_mini") is get_config("phi3-mini-3.8b")
    assert get_config("minitron_8b") is get_config("minitron-8b")
    assert get_config("chatglm3_6b") is get_config("chatglm3-6b")
    assert get_config("musicgen_large") is get_config("musicgen-large")
    assert get_config("internvl2_26b") is get_config("internvl2-26b")
    assert get_config("arctic_480b") is get_config("arctic-480b")
    assert get_config("kimi_k2") is get_config("kimi-k2-1t-a32b")
    with pytest.raises(KeyError, match="gemma2-9b"):
        get_config("no-such-arch")
