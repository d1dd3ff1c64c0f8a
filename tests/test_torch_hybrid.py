"""The port's zamba2-7b serving slice against the reference's, on the CPU.

Reduced zamba2 (4 Mamba-2 layers with the shared attention + MLP block after
layers 1 and 3, so 2 sites; d_model 64; 4 q heads padded to 16, 2 kv heads,
head_dim 16; window 8; chunk 16) in float32. The reference's weights, with
A_log and dt_bias set as Mamba-2 initialises them (the template's A_log = 1,
dt_bias = 0 decay the state to 0 within a chunk), are carried into the port
with ``params.from_numpy``. Prefill logits, the decode warm-up and decode
steps' logits, the caches and the ``serve`` output are held to the JAX
package's ``Model`` at rtol = atol = 2e-4 (the tolerance of the
reference's decode-vs-forward test, ``tests/test_models.py``), and greedy
tokens must be identical. The port's flash attention and SSD scan take
their plain versions here (CPU tensors).

Long context: the shared attention sees a window of 8. Up to 2 x the
window the reference's decode cache is full length and right, and the port
is held to it. Past that the cache is a ring of 8 slots, and the reference
masks a slot by its index instead of the position it holds
(``repro/models/attention.py:102-105`` against ``_write_cache`` at
``:168-174``), so once pos >= 8 it masks out the newest keys, the query's
own among them. The port masks by the held position: its ring decode
equals a full-length windowed decode at every step, and a test pins that
the reference's ring decode does not (ROADMAP C5).
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.launch import serve as port_serve
from repro_torch.models import Model, attention, params as port_params
from repro_torch.models import transformer

RTOL = ATOL = 2e-4
ARCH = "zamba2-7b"


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import Model as JaxModel
    from repro.models import transformer as jax_transformer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Model=JaxModel,
        transformer=jax_transformer)


def _hybrid_numpy_params(J, jp, seed=0):
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
    tree = _hybrid_numpy_params(J, jm.init(J.jax.random.PRNGKey(0)))
    jp = J.jax.tree.map(J.jnp.asarray, tree)
    cfg = reduced_config(get_config(ARCH))
    pm = Model(cfg, device="cpu", param_dtype=torch.float32)
    pp = port_params.from_numpy(tree, device="cpu")
    return cfg, jm, jp, pm, pp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _jax_decode_loop(J, jm, jp, toks, cache=None, long_context=False):
    """The reference's decode over given tokens (B, n), from `cache` (an
    empty one of n positions by default): every step's logits (B, n, Vp)
    and the last cache."""
    B, n = toks.shape
    if cache is None:
        cache = J.jax.tree.map(lambda s: J.jnp.zeros(s.shape, s.dtype),
                               jm.cache_template(B, n, J.jnp.float32))
    decode = J.jax.jit(functools.partial(jm.decode,
                                         long_context=long_context))
    out = []
    for i in range(n):
        logits, cache = decode(jp, cache, J.jnp.asarray(toks[:, i:i + 1]),
                               J.jnp.full((B,), i, J.jnp.int32))
        out.append(np.asarray(logits))
    return np.stack(out, axis=1), cache


def _port_decode_loop(pm, pp, toks, cache, long_context=None):
    """The port's decode over given tokens from `cache`: through
    ``Model.decode``, where the cache decides the window, or, with
    `long_context` given, through ``transformer.decode_step`` with that
    flag."""
    t = torch.from_numpy(toks).long()
    B, n = toks.shape
    out = []
    for i in range(n):
        args = (pp, cache, t[:, i:i + 1], torch.full((B,), i))
        if long_context is None:
            logits, cache = pm.decode(*args)
        else:
            logits, cache = transformer.decode_step(
                *args, pm.cfg, long_context=long_context)
        out.append(logits.numpy())
    return np.stack(out, axis=1), cache


def _port_full_length_cache(pm, B, n):
    """The port's hybrid cache with n attention slots whatever n: the
    full-length windowed cache the ring stands in for."""
    cache = pm.cache_template(B, 2 * pm.cfg.sliding_window)
    for k in ("ak", "av"):
        shape = list(cache[k].shape)
        shape[2] = n
        cache[k] = torch.zeros(shape, dtype=cache[k].dtype)
    return cache


def _full_length_cache(J, jm, pm, B, n):
    """Both packages' full-length caches of n attention slots."""
    jt = jm.cache_template(B, 2 * jm.cfg.sliding_window, J.jnp.float32)
    jcache = {k: J.jnp.zeros(((s.shape[:2] + (n,) + s.shape[3:])
                              if k in ("ak", "av") else s.shape), s.dtype)
              for k, s in jt.items()}
    return jcache, _port_full_length_cache(pm, B, n)


# ---------------------------------------------------------------------------
# Configuration, template, weights
# ---------------------------------------------------------------------------
def test_reduced_config_is_the_references(reduced):
    cfg, jm, *_ = reduced
    assert cfg.family == "hybrid"
    assert (cfg.num_layers, transformer.n_attn_sites(cfg),
            attention.padded_heads(cfg), cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.sliding_window, cfg.ssm_chunk) == \
        (4, 2, 16, 4, 2, 16, 8, 16)
    assert [i for i in range(cfg.num_layers)
            if transformer.is_attn_site(cfg, i)] == [1, 3]
    assert cfg.param_count() == jm.cfg.param_count()


def test_full_zamba2_size(J):
    """81 layers and 13 sites; the shared attention's head dim is 112,
    which the flash kernels run on their 128 layout; the SSD runs 112
    heads of P = 64 with N = 64. ~6.75 B parameters, ~13.5 GB in bf16."""
    cfg = get_config(ARCH)
    count = port_params.count_params(transformer.model_template(cfg))
    assert count == J.Model(J.get_config(ARCH)).param_count()
    assert cfg.param_count() == J.get_config(ARCH).param_count()
    assert 6.7e9 < count < 6.8e9
    assert (cfg.num_layers, transformer.n_attn_sites(cfg)) == (81, 13)
    assert transformer.n_attn_sites(cfg) == \
        J.transformer.n_attn_sites(J.get_config(ARCH))
    assert (cfg.resolved_head_dim, attention.padded_heads(cfg),
            cfg.num_kv_heads) == (112, 32, 32)
    assert flash_kernel.layout_head_dim(cfg.resolved_head_dim) == 128
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state) == (112, 64, 64)
    assert Model(cfg, device="cpu").cache_template(1, 8192)["ak"].shape == \
        (13, 1, 8192, 32, 112)


def test_from_numpy_carries_the_shared_subtree(J, reduced):
    cfg, jm, jp, pm, pp = reduced
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(pp["shared"]["attn"][name].numpy(),
                                      np.asarray(jp["shared"]["attn"][name]))
    for name in ("wg", "wu", "wd"):
        np.testing.assert_array_equal(pp["shared"]["mlp"][name].numpy(),
                                      np.asarray(jp["shared"]["mlp"][name]))
    assert pp["shared"]["ln1"].dtype == torch.float32


def test_init_zeroes_the_shared_blocks_padded_heads(J):
    """The reference's _fixup on the hybrid family zeroes the padded heads'
    wo rows of the shared block (the port's would have raised a KeyError
    on the stacked layers' missing attention)."""
    cfg = reduced_config(get_config(ARCH))
    p = Model(cfg, device="cpu", param_dtype=torch.float32).init(0)
    mask = attention.head_mask(cfg)
    wo = p["shared"]["attn"]["wo"]
    assert int(mask.sum()) == cfg.num_heads
    assert torch.count_nonzero(wo[mask == 0]) == 0
    assert torch.count_nonzero(wo[mask == 1]) == wo[mask == 1].numel()
    jp = J.Model(J.reduced_config(J.get_config(ARCH)),
                 param_dtype=J.jnp.float32).init(J.jax.random.PRNGKey(0))
    jwo = np.asarray(jp["shared"]["attn"]["wo"])
    assert not np.any(jwo[mask.numpy() == 0])


# ---------------------------------------------------------------------------
# Prefill, decode, caches, serve
# ---------------------------------------------------------------------------
def test_prefill_matches_reference(J, reduced):
    """64 prompt tokens: four SSD chunks of 16 a layer, and the shared
    attention over all 64 positions at both sites."""
    cfg, jm, jp, pm, pp = reduced
    toks = _tokens(2, 64, cfg.vocab_size)
    jl, jcache = jm.prefill(jp, {"tokens": J.jnp.asarray(toks)})
    logits, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()})
    assert cache is None and jcache is None
    assert logits.shape == (2, cfg.padded_vocab)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


def test_forward_matches_reference_at_every_position(J, reduced):
    cfg, jm, jp, pm, pp = reduced
    toks = _tokens(2, 32, cfg.vocab_size, seed=1)
    want, _, _ = J.transformer.forward(jp, J.jnp.asarray(toks), jm.cfg)
    got, _ = transformer.forward(pp, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_decode_and_caches_match_reference(J, reduced):
    """A 24-token prompt fed through decode (warm_up), then 8 decode steps
    fed given tokens: the warm-up's last logits, every step's logits and
    greedy tokens, and the caches after the last step (SSM state and conv
    history of every layer, keys and values of both sites). 32 positions
    are past 2 x the window, so both caches are rings of 8 slots, which hold
    the last 8 positions: the port's ``Model.decode`` sees those 8 keys (the
    ring is its window), and so does the reference's decode without its
    window flag (its index mask passes every slot once pos >= 8)."""
    cfg, jm, jp, pm, pp = reduced
    B, P, n = 2, 24, 8
    toks = _tokens(B, P + n, cfg.vocab_size, seed=5)
    want, jcache = _jax_decode_loop(J, jm, jp, toks)
    t = torch.from_numpy(toks).long()
    last, cache = port_serve.warm_up(pm, pp, t[:, :P],
                                     pm.cache_template(B, P + n))
    np.testing.assert_allclose(last.numpy(), want[:, P - 1], rtol=RTOL,
                               atol=ATOL)
    for i in range(n):
        logits, cache = pm.decode(pp, cache, t[:, P + i:P + i + 1],
                                  torch.full((B,), P + i))
        np.testing.assert_allclose(logits.numpy(), want[:, P + i],
                                   rtol=RTOL, atol=ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      want[:, P + i].argmax(-1))
    assert sorted(cache) == sorted(jcache) == ["ak", "av", "conv", "state"]
    for k in cache:
        assert tuple(cache[k].shape) == tuple(jcache[k].shape), k
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_cache_template_matches_reference(J, reduced):
    """f32 SSM state and conv history whatever the dtype; the sites' keys
    and values in the given dtype, full length up to 2 x the window and a
    ring of the window's slots past it (the reference's rule)."""
    cfg, jm, jp, pm, pp = reduced
    for seq in (10, 16, 17, 40):
        cache = Model(cfg, device="cpu").cache_template(3, seq)
        want = jm.cache_template(3, seq)
        assert sorted(cache) == sorted(want)
        for k in cache:
            assert tuple(cache[k].shape) == tuple(want[k].shape), (seq, k)
            assert torch.count_nonzero(cache[k]) == 0
        assert cache["state"].dtype == cache["conv"].dtype == torch.float32
        assert cache["ak"].dtype == torch.bfloat16  # the model's dtype
        assert cache["ak"].shape[2] == (8 if seq > 16 else seq)


def test_prefill_matches_its_own_decode_warm_up(reduced):
    """The scan and the flash path against the recurrence and the cached
    decode in the port alone: the prefill's last logits equal the warm-up's
    over the same 16 tokens (2 x the window: past it the cache is a ring of
    the window's slots, which sees the last 8 positions only, as the
    reference's does)."""
    cfg, jm, jp, pm, pp = reduced
    t = torch.from_numpy(_tokens(2, 16, cfg.vocab_size, seed=6)).long()
    want, _ = pm.prefill(pp, {"tokens": t})
    got, _ = port_serve.warm_up(pm, pp, t, pm.cache_template(2, 16))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_serve_tokens_equal_reference_greedy_decode(J, reduced):
    """serve (prefill for the first token, warm-up, decode) against the
    reference's token-by-token greedy decode, as its serve CLI runs it; 12
    prompt tokens and 4 generated keep the cache full length (2 x the
    window), where the prefill and the decode see the same keys."""
    cfg, jm, jp, pm, pp = reduced
    B, P, G = 2, 12, 4
    prompts = _tokens(B, P, cfg.vocab_size, seed=7)
    jcache = J.jax.tree.map(lambda s: J.jnp.zeros(s.shape, s.dtype),
                            jm.cache_template(B, P + G, J.jnp.float32))
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
    np.testing.assert_allclose(logits.numpy(), j_prefill_logits, rtol=RTOL,
                               atol=ATOL)


def test_serve_one_token_is_the_prefill_argmax(reduced):
    cfg, jm, jp, pm, pp = reduced
    prompts = torch.from_numpy(_tokens(2, 16, cfg.vocab_size, seed=9)).long()
    tokens, logits = port_serve.serve(pm, pp, prompts, 1)
    want, _ = pm.prefill(pp, {"tokens": prompts})
    assert torch.equal(logits, want)
    assert torch.equal(tokens[:, 0], want.argmax(-1))
    longer, _ = port_serve.serve(pm, pp, prompts, 3)
    assert torch.equal(longer[:, :1], tokens)


def test_make_serve_steps_threads_force(reduced):
    """`force` reaches the kernels' wrappers; the prefill attends to every
    position (the reference's prefill never windows), 32 here."""
    cfg, jm, jp, pm, pp = reduced
    toks = torch.from_numpy(_tokens(1, 32, cfg.vocab_size, seed=8)).long()
    prefill, _ = port_serve.make_serve_steps(pm, force="ref")
    a, _ = prefill(pp, {"tokens": toks})
    b, _ = pm.prefill(pp, {"tokens": toks})
    full, _ = transformer.forward(pp, toks, cfg, last_only=True)
    windowed, _ = transformer.forward(pp, toks, cfg, last_only=True,
                                      long_context=True)
    assert torch.equal(a, b) and torch.equal(a, full[:, -1])
    assert not torch.equal(a, windowed[:, -1])
    prefill, _ = port_serve.make_serve_steps(pm, force="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill(pp, {"tokens": toks})


def test_bf16_model_serves_finite_logits():
    cfg = reduced_config(get_config(ARCH))
    m = Model(cfg, device="cpu")
    p = m.init(0)
    assert p["shared"]["attn"]["wq"].dtype == torch.bfloat16
    prompts = torch.from_numpy(_tokens(2, 32, cfg.vocab_size, seed=10)).long()
    tokens, logits = port_serve.serve(m, p, prompts, 4)
    assert tokens.shape == (2, 4) and bool(torch.isfinite(logits).all())


def test_serve_main_runs_zamba2_on_the_cpu(capsys):
    tokens = port_serve.main(["--arch", "zamba2_7b", "--device", "cpu",
                              "--batch", "2", "--prompt_len", "16",
                              "--gen_len", "4"])
    assert tokens.shape == (2, 4)
    assert "served batch=2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Long context: the window, the full-length cache and the ring
# ---------------------------------------------------------------------------
def test_long_context_prefill_matches_reference(J, reduced):
    """The shared attention under its window of 8 over 32 positions."""
    cfg, jm, jp, pm, pp = reduced
    toks = _tokens(2, 32, cfg.vocab_size, seed=11)
    want, _, _ = J.transformer.forward(jp, J.jnp.asarray(toks), jm.cfg,
                                       long_context=True)
    got, _ = transformer.forward(pp, torch.from_numpy(toks).long(), cfg,
                                 long_context=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    plain, _ = transformer.forward(pp, torch.from_numpy(toks).long(), cfg)
    assert float((got - plain).abs().max()) > 100 * ATOL  # the window bites


def test_long_context_decode_within_two_windows_matches_reference(J, reduced):
    """16 positions, 2 x the window: the reference's cache is full length
    and its windowed decode right; the port's equals it at every step."""
    cfg, jm, jp, pm, pp = reduced
    B, n = 2, 2 * cfg.sliding_window
    toks = _tokens(B, n, cfg.vocab_size, seed=12)
    want, jcache = _jax_decode_loop(J, jm, jp, toks, long_context=True)
    cache = pm.cache_template(B, n)
    assert cache["ak"].shape[2] == n
    got, cache = _port_decode_loop(pm, pp, toks, cache, long_context=True)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # and the window changes the answer past its 8 positions
    plain, _ = _jax_decode_loop(J, jm, jp, toks)
    assert np.abs(plain[:, 8:] - want[:, 8:]).max() > 100 * ATOL


def test_ring_decode_equals_full_length_windowed_decode(J, reduced):
    """24 positions, past 2 x the window: the cache is a ring of 8 slots.
    The port's ring decode (``Model.decode``: no flag, the ring is the
    window) equals a full-length windowed decode (24 slots, the reference's
    and the port's) at every step."""
    cfg, jm, jp, pm, pp = reduced
    B, n = 2, 3 * cfg.sliding_window
    toks = _tokens(B, n, cfg.vocab_size, seed=13)
    ring = pm.cache_template(B, n)
    assert ring["ak"].shape[2] == cfg.sliding_window
    got, _ = _port_decode_loop(pm, pp, toks, ring)  # the ring is the window
    jfull, full = _full_length_cache(J, jm, pm, B, n)
    want, _ = _jax_decode_loop(J, jm, jp, toks, cache=jfull,
                               long_context=True)
    mine, _ = _port_decode_loop(pm, pp, toks, full, long_context=True)
    np.testing.assert_allclose(mine, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_serve_past_two_windows_decodes_over_the_ring(reduced):
    """32 prompt tokens and 5 generated, past 2 x the window: the first
    token is the prefill's (every position seen), the others are greedy
    over a full-length windowed decode of the same prompt: the ring that
    ``serve`` builds is the window."""
    cfg, jm, jp, pm, pp = reduced
    B, P, G = 2, 32, 5
    prompts = _tokens(B, P, cfg.vocab_size, seed=15)
    tokens, logits = port_serve.serve(pm, pp,
                                      torch.from_numpy(prompts).long(), G)
    first, _ = pm.prefill(pp, {"tokens": torch.from_numpy(prompts).long()})
    assert torch.equal(logits, first)
    assert torch.equal(tokens[:, 0], first.argmax(-1))
    full = _port_full_length_cache(pm, B, P + G)
    fed = torch.from_numpy(prompts).long()
    want = [first.argmax(-1)]
    for i in range(P + G - 1):
        tok = fed[:, i:i + 1] if i < P else want[-1][:, None]
        step, full = transformer.decode_step(pp, full, tok,
                                             torch.full((B,), i), cfg,
                                             long_context=True)
        if i >= P:
            want.append(step.argmax(-1))
    np.testing.assert_array_equal(tokens.numpy(),
                                  torch.stack(want, dim=1).numpy())


def test_reference_ring_decode_departs_from_the_windowed_decode(J, reduced):
    """The fault the port does not copy: the reference's ring decode
    (its own cache_template past 2 x the window) equals the full-length
    windowed decode while pos < 8, and parts from it from pos = 8 on, where
    its index mask drops the newest keys."""
    cfg, jm, jp, pm, pp = reduced
    B, n, w = 2, 3 * cfg.sliding_window, cfg.sliding_window
    toks = _tokens(B, n, cfg.vocab_size, seed=13)
    assert jm.cache_template(B, n)["ak"].shape[2] == w
    ring, _ = _jax_decode_loop(J, jm, jp, toks, long_context=True)
    jfull, _ = _full_length_cache(J, jm, pm, B, n)
    want, _ = _jax_decode_loop(J, jm, jp, toks, cache=jfull,
                               long_context=True)
    np.testing.assert_allclose(ring[:, :w], want[:, :w], rtol=RTOL, atol=ATOL)
    gap = np.abs(ring[:, w:] - want[:, w:]).max(axis=(0, 2))
    assert (gap > 100 * ATOL).all(), gap


def test_decode_attn_heads_masks_a_ring_by_held_position(reduced):
    """One attention call: a ring of 8 slots holding positions 12..19
    (pos 19 in slot 3) against the same keys in a 20-slot cache, with and
    without a window; and a full-length cache is masked as before (slots
    past pos unseen)."""
    cfg, jm, jp, pm, pp = reduced
    rng = np.random.default_rng(14)
    B, S, W, KV, hd = 2, 20, 8, cfg.num_kv_heads, cfg.resolved_head_dim
    h = torch.from_numpy((rng.normal(size=(B, 1, cfg.d_model)) * 0.5)
                         .astype(np.float32))
    full_k = torch.from_numpy(rng.normal(size=(B, S, KV, hd))
                              .astype(np.float32))
    full_v = torch.from_numpy(rng.normal(size=(B, S, KV, hd))
                              .astype(np.float32))
    pos = torch.full((B,), S - 1)
    held = torch.arange(S - W, S)
    ring_k = torch.zeros(B, W, KV, hd)
    ring_v = torch.zeros(B, W, KV, hd)
    ring_k[:, held % W] = full_k[:, held]
    ring_v[:, held % W] = full_v[:, held]
    p = pp["shared"]["attn"]
    for window in (0, W, 5):
        want, _ = attention.decode_attn_heads(p, h, cfg, full_k.clone(),
                                              full_v.clone(), pos,
                                              window=window or W)
        got, _ = attention.decode_attn_heads(p, h, cfg, ring_k.clone(),
                                             ring_v.clone(), pos,
                                             window=window)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    # slots past pos in a full-length cache stay unseen, whatever they hold
    early = torch.full((B,), 9)
    a, _ = attention.decode_attn_heads(p, h, cfg, full_k.clone(),
                                       full_v.clone(), early)
    junk_k, junk_v = full_k.clone(), full_v.clone()
    junk_k[:, 10:] = 1e3
    junk_v[:, 10:] = -1e3
    b, _ = attention.decode_attn_heads(p, h, cfg, junk_k, junk_v, early)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
