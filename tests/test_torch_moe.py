"""The port's MoE family against the reference's, on the CPU.

``models.moe.route`` is held BITWISE to the reference's own routing steps:
the lines of ``repro.models.moe.moe_forward`` from ``jax.lax.top_k`` to
the slot map, read from its source and run on the reference's f32
probabilities. The cases cover exact ties at the k-th place (where
``torch.topk`` picks another of the tied experts than ``jax.lax.top_k``),
the published routing widths (arctic-480b's 128 experts top-2 and
kimi-k2's 384 top-8, from bf16 router logits, where ties are common) and a
skewed router that puts more than an expert's capacity on it, so that
tokens are dropped.

``moe_forward``'s output and auxiliary loss are held at F32_REDUCTION at
the reduced configs and at each published routing width on narrow experts
(d 64, f 32, 2 x 512 tokens), and with drops. Each of these cases asserts
a margin of ``TOP_K_MARGIN`` between the k-th and (k+1)-th reference
probability of every token, so that no route can flip on f32 summation
order; their router is scaled to unit-std logits to give that margin.

Reduced arctic (dense residual) and kimi: prefill, 8 decode steps and
``serve`` at rtol = atol = 2e-4 (the reference's decode-vs-forward
tolerance, ``tests/test_models.py``) with identical greedy tokens; the
loss and its aux at F32_REDUCTION, and every gradient leaf at
F32_REDUCTION of its max, through ``from_numpy`` of the reference's
parameters. ``init`` zeroes the padded heads' wo rows (arctic's 56 heads
padded to 64), and drawing an expert leaf one (layer, expert) slice at a
time leaves every other leaf bitwise the earlier per-layer draw.
"""
import dataclasses
import inspect
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import Model, attention, moe
from repro_torch.models import params as port_params
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves
from repro_torch.testing.padded_heads import padded_wo_gradient, unpadded
from repro_torch.testing.tolerances import F32_REDUCTION

RTOL = ATOL = 2e-4
ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
# the least relative gap between a token's k-th and (k+1)-th probability in
# the moe_forward cases: f32 summation order moves a probability by ~1e-7
TOP_K_MARGIN = 1e-6


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import Model as JaxModel
    from repro.models import moe as jax_moe
    from repro.models import params as jax_params
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Model=JaxModel, moe=jax_moe,
        params=jax_params)


# ---------------------------------------------------------------------------
# routing, bitwise
# ---------------------------------------------------------------------------
def reference_route(J, probs, k, capacity_factor=1.25):
    """The reference's routing steps on (T, E) f32 `probs`: the lines of
    ``repro.models.moe.moe_forward`` from its top-k to its slot map, run as
    they are written. Returns their namespace (gate, idx, cap, pos, keep,
    dest, slot_src, ...)."""
    lines = inspect.getsource(J.moe.moe_forward).splitlines()
    start = next(i for i, line in enumerate(lines)
                 if "jax.lax.top_k(probs, k)" in line)
    end = next(i for i, line in enumerate(lines)
               if line.strip().startswith("slot_src = slot_src.at[dest]"))
    ns = dict(jax=J.jax, jnp=J.jnp, probs=J.jnp.asarray(probs), k=k,
              T=probs.shape[0], E=probs.shape[1],
              capacity_factor=capacity_factor)
    exec(textwrap.dedent("\n".join(lines[start:end + 1])), ns)
    return ns


def _bf16_router_probs(J, T, E, seed, skew=0.0):
    """(T, E) f32 probabilities as the reference's router gives them in
    bf16: x (T, 64) and the router drawn at scale 0.1 / sqrt(d), their
    product rounded to bf16, then cast to f32 and the softmax taken.
    `skew` is added to expert 0's logit."""
    rng = np.random.default_rng(seed)
    jnp = J.jnp
    x = jnp.asarray(rng.normal(size=(T, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(64, E)) * 0.1 / 8.0, jnp.bfloat16)
    logits = jnp.einsum("td,de->te", x, w).astype(jnp.float32)
    logits = logits.at[:, 0].add(skew)
    return np.array(J.jax.nn.softmax(logits, axis=-1))


def _route_case(J, case):
    """(probs, k) of a routing case."""
    if case == "ties":
        # the issue's row and its like: four experts tied at 0.3, k = 3
        rows = [[0.1, .3, .3, .3, 0.0, .3], [.3, .3, 0.1, .3, .3, 0.0],
                [0.2, 0.2, 0.2, 0.2, 0.1, 0.1], [0.5, 0.1, 0.1, 0.1, 0.1, 0.1]]
        return np.asarray(rows * 64, np.float32), 3
    if case == "arctic":
        return _bf16_router_probs(J, 2048, 128, seed=1), 2
    if case == "kimi":
        return _bf16_router_probs(J, 1024, 384, seed=2), 8
    if case == "drops":
        return _bf16_router_probs(J, 2048, 8, seed=3, skew=4.0), 2
    raise ValueError(case)


def _kth_ties(probs, k):
    """Tokens whose k-th and (k+1)-th probabilities are equal."""
    s = -np.sort(-probs, axis=-1)
    return int((s[:, k - 1] == s[:, k]).sum())


@pytest.mark.parametrize("case", ["ties", "arctic", "kimi", "drops"])
def test_route_equals_the_reference_bitwise(J, case):
    probs, k = _route_case(J, case)
    want = reference_route(J, probs, k)
    got = moe.route(torch.from_numpy(probs), k)
    assert got.cap == want["cap"]
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want["idx"]))
    assert got.gate.numpy().tobytes() == np.asarray(
        want["gate"], np.float32).tobytes()
    for name, ref_name in (("pos", "pos"), ("keep", "keep"),
                           ("dest", "dest"), ("slots", "slot_src")):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(want[ref_name]),
                                      err_msg=name)
    if case != "drops":
        assert _kth_ties(probs, k) > 0, "no tie at the k-th place"
    else:
        dropped = int((~got.keep).sum())
        assert dropped > 0 and int((got.idx == 0).sum()) > got.cap, dropped


def test_torch_topk_breaks_the_tie_otherwise(J):
    """The trap the stable sort avoids: on the tie case torch.topk picks
    other experts than the reference, route the reference's."""
    probs, k = _route_case(J, "ties")
    want = np.asarray(J.jax.lax.top_k(J.jnp.asarray(probs), k)[1])
    topk = torch.topk(torch.from_numpy(probs), k).indices.numpy()
    assert (topk != want).any()
    np.testing.assert_array_equal(
        moe.route(torch.from_numpy(probs), k).idx.numpy(), want)


@pytest.mark.parametrize("T,k,E,cap", [(16, 2, 8, 256), (2048, 2, 8, 768),
                                       (16256, 2, 128, 512),
                                       (16256, 8, 384, 512),
                                       (4, 8, 384, 256)])
def test_capacity_is_the_references_rule(J, T, k, E, cap):
    probs = np.full((T, E), 1.0 / E, np.float32)
    if T * E <= 1 << 16:
        assert reference_route(J, probs, k)["cap"] == cap
    assert moe.capacity(T, k, E) == cap


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------
_FWD_CASES = {
    # (arch, E, k, d, f, tokens, router scale, skew)
    "arctic-reduced": ("arctic-480b", None, None, None, None, 2 * 24, 1.0,
                       0.0),
    "kimi-reduced": ("kimi-k2-1t-a32b", None, None, None, None, 2 * 24, 1.0,
                     0.0),
    "arctic-width": ("arctic-480b", 128, 2, 64, 32, 2 * 512, 10.0, 0.0),
    "kimi-width": ("kimi-k2-1t-a32b", 384, 8, 64, 32, 2 * 512, 10.0, 0.0),
    "drops": ("kimi-k2-1t-a32b", 8, 2, 64, 32, 2 * 1024, 10.0, 0.5),
}


def _fwd_case(J, name):
    """(jax cfg, port cfg, numpy params, h (B, S, d) float32)."""
    arch, E, k, d, f, tokens, scale, skew = _FWD_CASES[name]
    jcfg = J.reduced_config(J.get_config(arch))
    cfg = reduced_config(get_config(arch))
    if E is not None:
        change = dict(num_experts=E, experts_per_token=k, d_model=d, d_ff=f)
        jcfg = dataclasses.replace(jcfg, **change)
        cfg = dataclasses.replace(cfg, **change)
    tree = J.params.init_params(J.moe.moe_template(jcfg),
                                J.jax.random.PRNGKey(0), J.jnp.float32)
    tree = J.jax.tree.map(lambda a: np.array(a), tree)
    tree["router"] *= scale
    rng = np.random.default_rng(4)
    h = rng.normal(size=(2, tokens // 2, cfg.d_model)).astype(np.float32)
    if skew:  # tokens lean on expert 0: more than its capacity choose it
        h += skew
        tree["router"][:, 0] += skew
    return jcfg, cfg, tree, h


@pytest.mark.parametrize("name", list(_FWD_CASES))
def test_moe_forward_matches_reference(J, name):
    jcfg, cfg, tree, h = _fwd_case(J, name)
    jp = J.jax.tree.map(J.jnp.asarray, tree)
    want, want_aux = J.moe.moe_forward(jp, J.jnp.asarray(h), jcfg)
    want = np.asarray(want)
    # no route may flip on summation order: the k-th choice leads the next
    logits = np.asarray(J.jnp.einsum("td,de->te",
                                     J.jnp.asarray(h.reshape(-1, h.shape[-1])),
                                     jp["router"]))
    probs = np.asarray(J.jax.nn.softmax(logits, axis=-1))
    s = -np.sort(-probs, axis=-1)
    k = cfg.experts_per_token
    margin = (s[:, k - 1] - s[:, k]) / s[:, k - 1]
    assert margin.min() >= TOP_K_MARGIN, margin.min()

    pp = port_params.from_numpy(tree, device="cpu")
    out, aux = moe.moe_forward(pp, torch.from_numpy(h), cfg)
    assert out.shape == h.shape and out.dtype == torch.float32
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(out.numpy() - want).max()) <= \
        F32_REDUCTION.w_rel * scale
    assert abs(float(aux) - float(want_aux)) <= \
        F32_REDUCTION.obj_rel * max(abs(float(want_aux)),
                                    F32_REDUCTION.obj_floor)
    if name == "drops":
        r = moe.route(torch.softmax(torch.tensor(logits), -1), k)
        assert int((~r.keep).sum()) > 0


def test_dropped_tokens_contribute_zero():
    """A token whose every slot is dropped comes out of the MoE block as
    zeros (no dense residual), as in the reference."""
    cfg = dataclasses.replace(reduced_config(get_config("kimi-k2-1t-a32b")),
                              num_experts=2, experts_per_token=1)
    params = port_params.init_params(moe.moe_template(cfg),
                                     torch.Generator().manual_seed(0))
    params["router"].zero_()  # every token ties: each picks expert 0
    T = 600  # cap = int(1.25 x 600 / 2) = 375, rounded up to 512
    h = torch.ones(1, T, cfg.d_model)
    out, _ = moe.moe_forward(params, h, cfg)
    r = moe.route(torch.softmax(h[0] @ params["router"], -1), 1)
    assert r.cap == 512 and bool((r.idx == 0).all())
    assert torch.equal(r.keep, torch.arange(T) < 512)
    assert bool((out[0, 512:] == 0).all())
    assert bool((out[0, :512] != 0).any())


# ---------------------------------------------------------------------------
# reduced arctic and kimi: the model
# ---------------------------------------------------------------------------
_MODELS = {}


def _model_case(J, arch):
    """(port cfg, jax model, jax params, port model, port params)."""
    if arch not in _MODELS:
        jcfg = J.reduced_config(J.get_config(arch))
        jm = J.Model(jcfg, param_dtype=J.jnp.float32)
        jp = jm.init(J.jax.random.PRNGKey(0))
        cfg = reduced_config(get_config(arch))
        pm = Model(cfg, device="cpu", param_dtype=torch.float32)
        pp = port_params.from_numpy(J.jax.tree.map(np.asarray, jp),
                                    device="cpu")
        _MODELS[arch] = (cfg, jm, jp, pm, pp)
    return _MODELS[arch]


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(J, arch):
    cfg, jm, jp, pm, pp = _model_case(J, arch)
    toks = _tokens(2, 20, cfg.vocab_size, seed=3)
    jl, jcache = jm.prefill(jp, {"tokens": J.jnp.asarray(toks)})
    logits, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()})
    assert logits.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    for name in ("k", "v"):
        assert cache[name].shape == (2, 2, 20, cfg.num_kv_heads,
                                     cfg.resolved_head_dim)
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(J, arch):
    """8 decode steps token by token from an empty cache of 12 positions,
    the MoE block over each step's 2 tokens."""
    cfg, jm, jp, pm, pp = _model_case(J, arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_tokens_equal_reference_greedy(J, arch):
    """``serve`` against the reference's prefill, its cache copied into one
    of P + G positions, then its decode: 8 identical greedy tokens, and
    the prefill and every decode step's logits within the tolerance."""
    cfg, jm, jp, pm, pp = _model_case(J, arch)
    jnp = J.jnp
    B, P, G = 2, 16, 8
    prompts = _tokens(B, P, cfg.vocab_size, seed=7)
    want_logits, pre = jm.prefill(jp, {"tokens": jnp.asarray(prompts)})
    cache = {name: jnp.zeros(pre[name].shape[:2] + (P + G,)
                             + pre[name].shape[3:], pre[name].dtype)
             .at[:, :, :P].set(pre[name]) for name in ("k", "v")}
    jdecode = J.jax.jit(jm.decode)
    tok = jnp.argmax(want_logits, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(G - 1):
        step, cache = jdecode(jp, cache, tok[:, None],
                              jnp.full((B,), P + i, jnp.int32))
        tok = jnp.argmax(step, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    tokens, logits = port_serve.serve(pm, pp,
                                      torch.from_numpy(prompts).long(), G)
    assert tokens.shape == (B, G)
    np.testing.assert_array_equal(tokens.numpy(), np.stack(want, axis=1))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_leaf_match_reference(J, arch):
    cfg, jm, jp, pm, pp = _model_case(J, arch)
    B, S = 2, 24
    toks = _tokens(B, S, cfg.vocab_size, seed=9)
    targets = _tokens(B, S, cfg.vocab_size, seed=10)
    jbatch = {"tokens": J.jnp.asarray(toks),
              "targets": J.jnp.asarray(targets)}
    (want_loss, want_metrics), want_grads = J.jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True)(jp)
    params = {k: v for k, v in pp.items()}
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, metrics = pm.loss(params, {"tokens": torch.from_numpy(toks).long(),
                                     "targets": torch.from_numpy(targets)
                                     .long()})
    grads = torch.autograd.grad(loss, leaves)
    for leaf in leaves:
        leaf.requires_grad_(False)
    for got, want in ((loss.detach(), want_loss),
                      (metrics["aux"].detach(), want_metrics["aux"]),
                      (metrics["ce"].detach(), want_metrics["ce"])):
        assert abs(float(got) - float(want)) <= \
            F32_REDUCTION.obj_rel * abs(float(want)), (float(got),
                                                       float(want))
    assert float(metrics["aux"].detach()) > 0.5  # ~1 a layer if balanced
    want = [np.asarray(g) for g in J.jax.tree.leaves(want_grads)]
    assert [tuple(g.shape) for g in grads] == [w.shape for w in want]
    # the port's padded heads are inert (their wo rows take exactly 0); the
    # reference's wo gradient with those rows masked is the unpadded one's
    got = [g.numpy() for g in grads]
    assert padded_wo_gradient(cfg, params, got) == 0.0
    gaps = [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, unpadded(cfg, params, want))]
    assert max(gaps) <= F32_REDUCTION.w_rel, gaps


@pytest.mark.parametrize("alias,arch", [("arctic_480b", "arctic-480b"),
                                        ("kimi_k2", "kimi-k2-1t-a32b")])
def test_serve_main_runs_the_moe_family_on_the_cpu(alias, arch, capsys):
    tokens = port_serve.main(["--arch", alias, "--device", "cpu", "--batch",
                              "2", "--prompt_len", "12", "--gen_len", "4"])
    assert tokens.shape == (2, 4)
    assert f"of {arch}-smoke on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def test_init_zeroes_the_padded_heads_wo_rows():
    """arctic's 56 q heads over 8 kv heads pad to 64: the last of each
    group of 8 is padding, and its wo rows are zero in every layer."""
    cfg = dataclasses.replace(reduced_config(get_config("arctic-480b")),
                              num_heads=56, num_kv_heads=8, head_dim=8)
    assert attention.padded_heads(cfg) == 64
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    wo = model.init(0)["layers"]["attn"]["wo"]  # (L, 64, hd, d)
    padded = torch.arange(64) % 8 == 7
    assert bool((wo[:, padded] == 0).all())
    assert bool((wo[:, ~padded] != 0).all())
    assert torch.equal(attention.head_mask(cfg), (~padded).float())


def _per_layer_draw(template, seed):
    """The draw before expert leaves were drawn by slice: each leaf in
    sorted order, a stacked one a layer at a time."""
    gen = torch.Generator().manual_seed(seed)

    def one(spec):
        if spec.init in ("zeros", "ones"):
            return (torch.zeros if spec.init == "zeros" else torch.ones)(
                spec.shape)
        std = port_params._std(spec)
        parts = (range(spec.shape[0]) if spec.axes[0] == "layers"
                 else [None])
        out = torch.empty(spec.shape)
        for i in parts:
            view = out if i is None else out[i]
            view.copy_(torch.randn(view.shape, generator=gen) * std)
        return out

    return port_params.tree_map_specs(one, template)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b", "mamba2-130m",
                                  "internvl2-26b"])
def test_dense_leaves_draw_bitwise_as_before(arch):
    cfg = reduced_config(get_config(arch))
    template = transformer.model_template(cfg)
    got = port_params.init_params(template, torch.Generator().manual_seed(3))
    want = _per_layer_draw(template, 3)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_expert_leaves_draw_one_layer_and_expert_at_a_time():
    """An expert leaf (L, E, ...) is drawn slice by slice, in (layer,
    expert) order, each slice at the leaf's fan-in scale; the router and
    every other leaf as before."""
    cfg = reduced_config(get_config("arctic-480b"))
    template = transformer.model_template(cfg)
    got = port_params.init_params(template, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    for spec, leaf in zip(tree_leaves(template), tree_leaves(got)):
        if spec.init in ("zeros", "ones"):
            continue
        std = port_params._std(spec)
        if spec.axes[:2] == ("layers", "experts"):
            L, E = spec.shape[:2]
            want = torch.stack([torch.stack([
                torch.randn(spec.shape[2:], generator=gen) * std
                for _ in range(E)]) for _ in range(L)])
        elif spec.axes[0] == "layers":
            want = torch.stack([torch.randn(spec.shape[1:], generator=gen)
                                * std for _ in range(spec.shape[0])])
        else:
            want = torch.randn(spec.shape, generator=gen) * std
        assert leaf.numpy().tobytes() == want.numpy().tobytes(), spec
    wg = template["layers"]["moe"]["wg"]
    assert wg.axes[:2] == ("layers", "experts")
    # fan-in over (E, d), as the reference's rule counts it
    assert port_params._std(wg) == 1.0 / np.sqrt(cfg.num_experts *
                                                 cfg.d_model)
