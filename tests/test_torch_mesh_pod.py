"""Every family over a (pod x data x model) mesh of ranks, the reference's
multi-pod layout, and the hybrid trained on a grid whose model axis does
not divide its kv heads: on 4 spawned CPU ranks over gloo, against the
JAX package on a ``jax.sharding.Mesh`` of 4 host devices with axes
("pod", "data", "model") and against the port's own one-device step.

One spawn runs every rank job the tests read (``testing.multiprocess.
rank_lm``) while the reference's ``jit_train_step``s compile and run in
the parent, at reduced chatglm3-6b, arctic-480b (8 experts top-2, the
dense residual) and zamba2-7b, each at 16 q heads of 16 over 2 kv heads
(so that no head is padded: the reference's padded heads train, ROADMAP
C5), reduced mamba2-130m (8 SSM heads), and chatglm3-6b at 1 kv head
(its 'seq' decode). On a pod mesh 'pod' joins 'data' for the batch
(``sharding_rules.batch_axes``), the MoE FFN's hidden lies over ('pod',
'data') and its capacity over 'data' alone, and ZeRO-1 stays over
'data'.

Policies:

* the train cells (the dense family on (2, 2, 1) and (2, 1, 2), adamw,
  ZeRO-1, remat "collectives", 3 steps; arctic-480b 'gather' on
  (2, 2, 1) and 'token_tp' on (2, 1, 2), adafactor and adamw, remat
  "full"; mamba2-130m's layouts A (batch 2, the rows over ('pod',
  'data')) and B (batch 4, over ('pod', 'data', 'model')) and zamba2-7b's
  A on (2, 1, 2); zamba2-7b on the 2-axis (1, 4), its 2 kv heads
  replicated; 2 steps) against the reference's ``jit_train_step``: loss
  and grad norm to F32_REDUCTION, the parameters after each step to
  UPDATE_TOL x the reference's largest update of the leaf (adamw: at most
  ADAMW_FLIPS of a leaf's elements outside, as
  ``tests/test_torch_mesh_lm.py`` holds it);
* the two pods' parameters BITWISE equal after every step, ZeRO-1's
  gathered state and parameters after the first step BITWISE an
  unsharded update from the same summed gradients (adafactor's within
  F32_REDUCTION, as ``tests/test_torch_mesh_moe.py`` holds it);
* the gradients within GRAD_TOL of each leaf's largest entry of the
  one-device port's, the cells' and the batches that fall back to
  ('pod',) (batch 2 on (2, 2, 1)); the 'pod_grad' control (each pod
  keeping its own gradient) outside that rule; every rank's MoE route
  BITWISE the one-device port's route of the same batch;
* serving on (2, 1, 2): 'heads' decode (2 kv heads), 'seq' decode (1 kv
  head), mamba2-130m and zamba2-7b through ``warm_up`` on the cache's
  rows over ('pod', 'data'): every step's logits within SERVE_TOL (rtol =
  atol) of the reference's serve steps on the (2, 1, 2) jax mesh and of
  the one-device port's, the greedy tokens identical, each rank's cache
  the shape ``cache_pspecs`` gives; ``decode_attn_seq`` on
  (2, 1, 2) against the reference's with ``batch_axes=("pod", "data")``
  to F32_REDUCTION;
* the hybrid's serving cache on (1, 4) refused, as the reference cannot
  place it either (its ``device_put`` raises ValueError).
"""
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.distributed.sharding_rules import split_size
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models import params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.testing import multiprocess as mp
from repro_torch.testing.tolerances import F32_REDUCTION

HEADS = dict(num_heads=16, num_kv_heads=2, head_dim=16)
UPDATE_TOL, ADAMW_FLIPS = 2e-3, 1e-3
GRAD_TOL = 1e-4  # of each leaf's largest entry
SERVE_TOL = 2e-4
S, LR = 16, 3e-3
PROMPT, GEN = 12, 4
SEQ_B, SEQ_S, SEQ_POS = 2, 16, 9  # decode_attn_seq: pos 9 in rank 1's chunk
AXES = ("pod", "data", "model")
POD = (2, 1, 2)
MODELS = {"chatglm": ("chatglm3-6b", HEADS),
          "arctic": ("arctic-480b", HEADS),
          "mamba2": ("mamba2-130m", {}),
          "zamba2": ("zamba2-7b", HEADS),
          "chatglm-kv1": ("chatglm3-6b", dict(HEADS, num_kv_heads=1))}
# the train cells held to the reference: model, grid, batch, optimizer,
# MoE layout, remat, steps
CELLS = {
    "chatglm-221": ("chatglm", (2, 2, 1), 4, "adamw", "gather",
                    "collectives", 3),
    "chatglm-212": ("chatglm", POD, 4, "adamw", "gather", "collectives", 3),
    "arctic-gather-adafactor": ("arctic", (2, 2, 1), 4, "adafactor",
                                "gather", "full", 2),
    "arctic-gather-adamw": ("arctic", (2, 2, 1), 4, "adamw", "gather",
                            "full", 2),
    "arctic-token_tp-adafactor": ("arctic", POD, 4, "adafactor", "token_tp",
                                  "full", 2),
    "arctic-token_tp-adamw": ("arctic", POD, 4, "adamw", "token_tp", "full",
                              2),
    "mamba2-A": ("mamba2", POD, 2, "adamw", "gather", "collectives", 2),
    "mamba2-B": ("mamba2", POD, 4, "adamw", "gather", "collectives", 2),
    "zamba2-A": ("zamba2", POD, 4, "adamw", "gather", "collectives", 2),
    "zamba2-14": ("zamba2", (1, 4), 4, "adamw", "gather", "collectives", 2),
}
# gradients only: the batch of 2 on (2, 2, 1) lies over ('pod',) alone
# (``batch_axes``' fallback), the data ranks holding the same rows
FALLBACK = {"chatglm-221-b2": ("chatglm", (2, 2, 1), 2, "gather"),
            "arctic-221-b2": ("arctic", (2, 2, 1), 2, "gather"),
            "arctic-221-b2-token_tp": ("arctic", (2, 2, 1), 2, "token_tp")}
# the 'pod_grad' control, one cell a family
CONTROLLED = ("chatglm-212", "arctic-gather-adamw", "mamba2-B", "zamba2-A")
SERVES = ("chatglm", "chatglm-kv1", "mamba2", "zamba2")
MESH_GRIDS = ((2, 2, 1), (2, 1, 2), (2, 2))


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.data import tokens as jax_tokens
    from repro.distributed.sharding_rules import MOE_LAYOUTS
    from repro.launch import serve as jax_serve
    from repro.launch import train as jax_train
    from repro.models import Model as JaxModel
    from repro.models import attention as jax_attention
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Shape=JaxShape,
        tokens=jax_tokens, train=jax_train, serve=jax_serve, Model=JaxModel,
        layouts=MOE_LAYOUTS, attention=jax_attention)


def _mesh(J, grid):
    """A jax Mesh of 4 host devices (built from the devices, not
    ``jax.make_mesh``: ROADMAP C6)."""
    devs = np.array(J.jax.devices()[:4]).reshape(grid)
    return J.jax.sharding.Mesh(devs, AXES[-len(grid):])


def _cfgs(J, arch, extra):
    return (dataclasses.replace(J.reduced_config(J.get_config(arch)),
                                **extra),
            dataclasses.replace(reduced_config(get_config(arch)), **extra))


def _batches(J, cfg, B, steps):
    return [{k: np.asarray(v) for k, v in J.tokens.synthetic_token_batch(
        0, step, B, S, cfg.vocab_size).items()} for step in range(steps)]


def _seq_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    kv = (SEQ_B, SEQ_S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return dict(h=rng.normal(size=(SEQ_B, 1, cfg.d_model)).astype(np.float32),
                cache_k=rng.normal(size=kv).astype(np.float32),
                cache_v=rng.normal(size=kv).astype(np.float32),
                pos=np.full((SEQ_B,), SEQ_POS, np.int32))


def _settings(opt, layout):
    return dict(optimizer=opt, lr=LR, zero1=True, moe_layout=layout)


def _jobs(key, d):
    """A model's rank jobs: its cells' steps and gradients, the
    controls, the fall-back batches' gradients, and serving."""
    lm = []
    for name, (m, grid, B, opt, layout, remat, steps) in CELLS.items():
        if m != key:
            continue
        batches = d["batches"][name]
        lm.append(dict(kind="train", grid=grid, layout=layout, remat=remat,
                       tag=name, batches=batches,
                       settings=_settings(opt, layout)))
        lm.append(dict(kind="grads", grid=grid, layout=layout, tag=name,
                       batch=batches[0]))
        if name in CONTROLLED:
            lm.append(dict(kind="grads", grid=grid, layout=layout, tag=name,
                           batch=batches[0], controls=("pod_grad",)))
    for name, (m, grid, B, layout) in FALLBACK.items():
        if m == key:
            lm.append(dict(kind="grads", grid=grid, layout=layout, tag=name,
                           batch=d["batches"][name][0]))
    if key in SERVES:
        lm.append(dict(kind="serve", grid=POD, prompts=d["prompts"],
                       gen_len=GEN))
    if key == "chatglm":
        lm.append(dict(kind="serve_call", grid=POD, prompts=d["prompts"],
                       gen_len=GEN))
        lm += [dict(kind="mesh_axes", grid=g) for g in MESH_GRIDS]
    return lm


def _reference_steps(J, d, name):
    """The reference's ``jit_train_step`` of cell `name` on its jax mesh:
    each step's loss and grad norm and the parameters before and after
    it."""
    _, grid, B, opt, layout, remat, _ = CELLS[name]
    jm = J.Model(d["jcfg"], mesh=_mesh(J, grid), param_dtype=J.jnp.float32,
                 remat="full" if remat == "full" else "none",
                 rules_overrides=J.layouts[layout])
    settings = J.train.TrainSettings(optimizer=opt, lr=LR, zero1=True,
                                     moe_layout=layout)
    shape = J.Shape("t", "train", S, B)
    jstep, jopt, (_, _, param_sh, opt_sh, batch_sh) = \
        J.train.jit_train_step(jm, shape, settings)
    jp = J.jax.device_put(d["tree"], param_sh)
    js = J.jax.jit(jopt.init, out_shardings=opt_sh)(jp)
    steps = []
    for step, batch in enumerate(d["batches"][name]):
        old = [np.asarray(a) for a in J.jax.tree.leaves(jp)]
        jp, js, jmet = jstep(jp, js, J.jax.device_put(batch, batch_sh),
                             J.jnp.int32(step))
        steps.append(dict(
            loss=float(jmet["loss"]), grad_norm=float(jmet["grad_norm"]),
            old=old, new=[np.asarray(a) for a in J.jax.tree.leaves(jp)]))
    return steps


def _reference_serving(J, d):
    """The reference's serve steps (``make_serve_steps``, placed by
    ``serve_shardings``) on the (2, 1, 2) jax mesh: the prefill's logits,
    then GEN - 1 greedy decode steps on the prefill's cache (the dense
    family) or on the prompt fed through decode (the SSM and hybrid
    families, as the port's ``warm_up``). Returns the logits (B, GEN, Vp)
    and the greedy tokens (B, GEN)."""
    jm = J.Model(d["jcfg"], mesh=_mesh(J, POD), param_dtype=J.jnp.float32)
    prompts = d["prompts"].astype(np.int32)
    B, P = prompts.shape
    shape = J.Shape("s", "decode", P + GEN, B)
    prefill, decode = J.serve.make_serve_steps(jm, shape)
    param_sh, cache_sh, tok_sh, pos_sh = J.serve.serve_shardings(jm, shape)
    prefill = J.jax.jit(prefill, in_shardings=(param_sh, {"tokens": tok_sh}))
    decode = J.jax.jit(decode, in_shardings=(param_sh, cache_sh, tok_sh,
                                             pos_sh),
                       out_shardings=(None, cache_sh))
    params = J.jax.device_put(d["tree"], param_sh)
    logits, pre = prefill(params,
                          {"tokens": J.jax.device_put(prompts, tok_sh)})
    cache = {k: np.zeros(v.shape, np.float32)
             for k, v in jm.cache_template(B, P + GEN).items()}
    if pre is not None:
        for k in ("k", "v"):
            cache[k][:, :, :P] = np.asarray(pre[k])
    cache = J.jax.device_put(cache, cache_sh)

    def step(cache, tok, pos):
        return decode(params, cache, J.jax.device_put(tok, tok_sh),
                      J.jax.device_put(np.full((B,), pos, np.int32), pos_sh))

    if pre is None:
        for i in range(P):
            _, cache = step(cache, prompts[:, i:i + 1], i)
    out = [np.asarray(logits).reshape(B, -1)]
    for i in range(GEN - 1):
        tok = out[-1].argmax(-1).astype(np.int32)[:, None]
        logits, cache = step(cache, tok, P + i)
        out.append(np.asarray(logits).reshape(B, -1))
    out = np.stack(out, 1)
    return out, out.argmax(-1)


@pytest.fixture(scope="module")
def setup(J):
    """Per model: the configs, the reference's parameters (numpy), the
    cells' batches and prompts; one spawn of 4 CPU ranks for every rank
    job, run while the reference's train and serve steps compile and run
    here."""
    out, jobs = {}, []
    for i, (key, (arch, extra)) in enumerate(MODELS.items()):
        jcfg, pcfg = _cfgs(J, arch, extra)
        jm = J.Model(jcfg, mesh=None, param_dtype=J.jnp.float32)
        tree = J.jax.tree.map(np.asarray, jm.init(J.jax.random.PRNGKey(i)))
        d = dict(jcfg=jcfg, pcfg=pcfg, tree=tree, batches={})
        for name, cell in list(CELLS.items()) + list(FALLBACK.items()):
            if cell[0] == key:
                steps = cell[6] if name in CELLS else 1
                d["batches"][name] = _batches(J, pcfg, cell[2], steps)
        d["prompts"] = np.random.default_rng(7 + i).integers(
            0, pcfg.vocab_size, (4, PROMPT)).astype(np.int64)
        d["lm"] = _jobs(key, d)
        jobs.append((mp.rank_lm, (pcfg, tree, d["lm"], "cpu")))
        if key == "chatglm-kv1":
            d["attn"] = {k: v[0] for k, v in tree["layers"]["attn"].items()}
            d["seq"] = [dict(kind="decode_seq", grid=POD, window=w,
                             **_seq_inputs(pcfg, 20)) for w in (0, 5)]
            jobs.append((mp.rank_lm, (pcfg, d["attn"], d["seq"], "cpu")))
        out[key] = d
    done = {}

    def spawn():
        try:
            done["launch"] = mp.launch_coordinated(
                mp.rank_batch, 4, (jobs,), backend="gloo", timeout=300)
        except BaseException as e:  # re-raised below, in the test's thread
            done["error"] = e

    ranks = threading.Thread(target=spawn)
    ranks.start()
    try:
        refs = {name: _reference_steps(J, out[cell[0]], name)
                for name, cell in CELLS.items()}
        serving = {key: _reference_serving(J, out[key]) for key in SERVES}
    finally:
        ranks.join()
    if "error" in done:
        raise done["error"]
    launch = done["launch"]
    assert launch.exit_codes == {}, launch.errors
    k = 0
    for key, d in out.items():
        d["ranks"] = [r[k] for r in launch.results]
        k += 1
        if key == "chatglm-kv1":
            d["seq_ranks"] = [r[k] for r in launch.results]
            k += 1
    out["refs"], out["serving"] = refs, serving
    return out


def _matches(job, field, value):
    got = job.get(field)
    if field == "controls":
        return tuple(got or ()) == tuple(value or ())
    return got == value


def _job(d, kind, **match):
    """Every rank's result of the first job of `kind` whose fields are
    `match` (an absent field matches None)."""
    for k, job in enumerate(d["lm"]):
        if job["kind"] == kind and all(_matches(job, f, v)
                                       for f, v in match.items()):
            return [r[k] for r in d["ranks"]]
    raise KeyError((kind, match))


def _cell(name):
    return CELLS.get(name) or FALLBACK[name]


def _one_device(d, batch):
    """The one-device port's loss and gradients of `batch`, and its
    routes (an MoE model's)."""
    model = Model(d["pcfg"], device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    with mp.routes_recorded() as seen:
        loss, _, grads = port_train.loss_and_grads(
            model, params,
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return float(loss), [g.numpy() for g in tree_leaves(grads)], seen


def _grad_misses(got, want):
    """Leaves (by index) outside GRAD_TOL of the leaf's largest entry."""
    return [i for i, (a, b) in enumerate(zip(tree_leaves(got), want))
            if np.abs(a - b).max() > GRAD_TOL * np.abs(b).max()]


def _pods(grid):
    """Two ranks of one (data, model) place in different pods, when the
    grid has pods: (0, the first rank of the second pod)."""
    return (0, grid[1] * grid[2]) if len(grid) == 3 else None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_train_step_matches_reference_jit_train_step(setup, cell):
    m, grid, _, opt, *_ = CELLS[cell]
    d = setup[m]
    res = _job(d, "train", tag=cell)
    for r in res[1:]:  # every rank gathers the same trees
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(r["params"][-1]), tree_leaves(res[0]["params"][-1])))
    got = res[0]
    flips = ADAMW_FLIPS if opt == "adamw" else 0.0
    for step, ref in enumerate(setup["refs"][cell]):
        for key in ("loss", "grad_norm"):
            w = ref[key]
            assert abs(got["metrics"][step][key] - w) <= \
                F32_REDUCTION.obj_rel * w, (step, key)
        for j0, j1, p1 in zip(ref["old"], ref["new"],
                              tree_leaves(got["params"][step])):
            bound = UPDATE_TOL * np.abs(j1 - j0).max()
            missed = float((np.abs(p1 - j1) > bound).mean())
            assert missed <= flips, (step, j1.shape, missed)


@pytest.mark.parametrize("cell", sorted(c for c in CELLS
                                        if len(CELLS[c][1]) == 3))
def test_the_pods_parameters_are_bitwise_equal_after_every_step(setup,
                                                                cell):
    """Each pod updates the same ZeRO-1 slices from the same summed
    gradients: the parameters each pod holds (gathered over the model
    and data axes within it) are the same bits after every step."""
    m, grid = CELLS[cell][:2]
    res = _job(setup[m], "train", tag=cell)
    a, b = _pods(grid)
    for step in range(CELLS[cell][6]):
        assert all(np.array_equal(x, y) for x, y in zip(
            tree_leaves(res[a]["params"][step]),
            tree_leaves(res[b]["params"][step]))), step


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_zero1_state_is_an_unsharded_update(setup, cell):
    """ZeRO-1 over 'data' alone: the gathered state and parameters after
    the first step are an unsharded update of the same summed gradients,
    adamw's bitwise, adafactor's within F32_REDUCTION."""
    m, _, _, opt, *_ = CELLS[cell]
    for got in _job(setup[m], "train", tag=cell):
        ref = got["unsharded"]
        for a, b in zip(tree_leaves(got["gathered_state"]) + tree_leaves(
                got["params"][0]), tree_leaves(ref["state"])
                + tree_leaves(ref["params"])):
            if opt == "adamw":
                assert np.array_equal(a, b)
            else:
                assert np.abs(a - b).max() <= F32_REDUCTION.w_rel * max(
                    np.abs(b).max(), 1.0)


@pytest.mark.parametrize("cell", sorted(CELLS) + sorted(FALLBACK))
def test_mesh_gradients_match_one_device(setup, cell):
    m = _cell(cell)[0]
    d = setup[m]
    batch = d["batches"][cell][0]
    loss, want, seen = _one_device(d, batch)
    res = _job(d, "grads", tag=cell, controls=None)
    for r in res:
        assert abs(r["loss"] - loss) <= F32_REDUCTION.obj_rel * loss
        assert not _grad_misses(r["grads"], want), (cell, r["calls"])
    if d["pcfg"].num_experts:  # every rank routes the global batch
        for layer, rec in enumerate(res[0]["routes"]):
            for r in res:
                mine = r["routes"][layer]
                assert mine["again"]
                for f in ("probs", "idx", "pos", "keep", "slots"):
                    assert np.array_equal(mine[f], rec[f]), (layer, f)
            assert np.array_equal(rec["idx"], seen[layer][1].idx.numpy())
            assert np.array_equal(rec["keep"], seen[layer][1].keep.numpy())


@pytest.mark.parametrize("cell", CONTROLLED)
def test_pod_grad_control_falls_outside_the_gradient_rule(setup, cell):
    """Each pod keeping its own gradient (the sum over 'pod' dropped)
    misses the rule; the step's own gradients tag that sum 'pod_grads'."""
    d = setup[CELLS[cell][0]]
    _, want, _ = _one_device(d, d["batches"][cell][0])
    got = _job(d, "grads", tag=cell, controls=("pod_grad",))[0]
    assert _grad_misses(got["grads"], want)
    assert "pod_grads" not in got["calls"]
    assert _job(d, "grads", tag=cell, controls=None)[0]["calls"][
        "pod_grads"] > 0


def test_the_layouts_run_on_the_pod_mesh(setup):
    """The batch's axes on (2, 1, 2): mamba2-130m's layout A runs its
    heads tensor-parallel, B gathers the split leaves; arctic-480b's
    'gather' gathers the FFN over ('pod', 'data') and 'token_tp' never."""
    a = _job(setup["mamba2"], "grads", tag="mamba2-A",
             controls=None)[0]["calls"]
    b = _job(setup["mamba2"], "grads", tag="mamba2-B",
             controls=None)[0]["calls"]
    L = setup["mamba2"]["pcfg"].num_layers
    assert a["ssm_norm"] == 2 * L and "ssm_weights" not in a
    assert b["ssm_weights"] == 2 * 9 * L and "ssm_norm" not in b
    g = _job(setup["arctic"], "grads", tag="arctic-gather-adamw",
             controls=None)[0]["calls"]
    t = _job(setup["arctic"], "grads", tag="arctic-token_tp-adamw",
             controls=None)[0]["calls"]
    assert g["moe_weights"] > 0 and "moe_weights" not in t


def _one_device_serving(model, params, prompts, tokens):
    """The one-device port's logits (B, GEN, Vp) for `prompts` fed the
    greedy `tokens`: the prefill's, then GEN - 1 decode steps on the
    prefill's cache (the dense family) or on ``warm_up``'s (the SSM and
    hybrid families)."""
    prefill, decode = port_serve.make_serve_steps(model)
    with torch.no_grad():
        logits, pre = prefill(params, {"tokens": prompts})
        B, P = prompts.shape
        cache = model.cache_template(B, P + GEN)
        if pre is None:
            _, cache = port_serve.warm_up(model, params, prompts, cache)
        else:
            cache = port_serve.fill_cache(model, cache, pre, P)
        out = [logits]
        for i in range(GEN - 1):
            pos = torch.full((B,), P + i, dtype=torch.long)
            logits, cache = decode(params, cache, tokens[:, i:i + 1], pos)
            out.append(logits)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("key", SERVES)
def test_pod_serving_matches_one_device(setup, key):
    d = setup[key]
    cfg = d["pcfg"]
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    prompts = torch.from_numpy(d["prompts"])
    B = prompts.shape[0]
    sizes = dict(zip(AXES, POD))
    layout = Model(cfg, device="cpu", mesh=sizes)
    shape = ShapeConfig("s", "decode", PROMPT + GEN, B)
    specs = layout.cache_pspecs(shape)
    assert port_serve.serve_row_axes(layout, shape) == ("pod", "data")
    whole = model.cache_template(B, PROMPT + GEN, device="meta")
    want = {k: tuple(n // split_size(sizes, a)
                     for n, a in zip(whole[k].shape, specs[k]))
            for k in whole}
    rows = B // 2
    tokens, _ = port_serve.serve(model, params, prompts, GEN)
    for r in _job(d, "serve"):
        mine = slice(r["row_block"] * rows, (r["row_block"] + 1) * rows)
        assert r["row_block"] == r["coordinate"][0]  # ('pod', 'data')
        assert r["cache_shapes"] == want, r["coordinate"]
        ref = _one_device_serving(model, params, prompts[mine],
                                  torch.from_numpy(r["tokens"]))
        assert np.allclose(r["logits"], ref, rtol=SERVE_TOL, atol=SERVE_TOL)
        assert np.array_equal(ref.argmax(-1), r["tokens"])
        assert np.array_equal(r["tokens"], tokens[mine].numpy())
        if key == "chatglm-kv1":
            assert "decode_q" in r["decode_calls"]
    if key == "chatglm":
        for r in _job(d, "serve_call"):
            mine = slice(r["row_block"] * rows, (r["row_block"] + 1) * rows)
            assert np.array_equal(r["tokens"], tokens[mine].numpy())


@pytest.mark.parametrize("key", SERVES)
def test_pod_serving_matches_reference_serve_steps(setup, key):
    """The ranks' serving on (2, 1, 2) against the reference's serve
    steps on the same ("pod", "data", "model") jax mesh: each rank's rows'
    logits within SERVE_TOL (rtol = atol), the greedy tokens identical."""
    logits, tokens = setup["serving"][key]
    rows = tokens.shape[0] // 2
    for r in _job(setup[key], "serve"):
        mine = slice(r["row_block"] * rows, (r["row_block"] + 1) * rows)
        assert r["logits"].shape == logits[mine].shape
        assert np.allclose(r["logits"], logits[mine], rtol=SERVE_TOL,
                           atol=SERVE_TOL), r["coordinate"]
        assert np.array_equal(r["tokens"], tokens[mine]), r["coordinate"]


def test_decode_attn_seq_matches_reference_over_pod_and_data(J, setup):
    """'seq' decode at 1 kv head on (2, 1, 2), the batch over ('pod',
    'data'), against the reference's with ``batch_axes=("pod",
    "data")``: the output and the cache."""
    d = setup["chatglm-kv1"]
    mesh = _mesh(J, POD)
    p = {k: J.jnp.asarray(v) for k, v in d["attn"].items()}
    for job, res in zip(d["seq"], zip(*d["seq_ranks"])):
        want, (wk, wv) = J.attention.decode_attn_seq(
            p, J.jnp.asarray(job["h"]), d["jcfg"],
            J.jnp.asarray(job["cache_k"]), J.jnp.asarray(job["cache_v"]),
            J.jnp.asarray(job["pos"]), mesh, window=job["window"],
            batch_axes=("pod", "data"))
        for r in res:
            for got, ref in ((r["out"], want), (r["cache_k"], wk),
                             (r["cache_v"], wv)):
                ref = np.asarray(ref)
                assert np.abs(got - ref).max() <= F32_REDUCTION.w_rel * \
                    max(np.abs(ref).max(), 1.0), job["window"]
    a, b = (np.asarray(r["out"]) for r in d["seq_ranks"][0])
    assert not np.allclose(a, b)  # the window matters at this position


@pytest.mark.parametrize("grid", MESH_GRIDS)
def test_the_mesh_lays_its_axes_as_jax_orders_them(setup, grid):
    """``core.distributed.Mesh`` on 4 ranks: rank r at (o, p, q) with r =
    (o x data + p) x model + q; each axis and tuple of axes (the first
    major) gives its size, the rank's block (jax's order of a dim split
    over the tuple) and a group whose ranks, in group order, are that
    block order; one pod is the 2-axis grid."""
    names = AXES[-len(grid):]
    sizes = dict(zip(names, grid))
    for rank, r in enumerate(_job(setup["chatglm"], "mesh_axes",
                                  grid=grid)):
        coord = np.unravel_index(rank, grid)
        for axis, found in r.items():
            if axis in ("sum", "refused"):
                continue
            size, block, group = found
            ax = axis if isinstance(axis, tuple) else (axis,)
            assert size == split_size(sizes, ax)
            assert block == np.ravel_multi_index(
                [coord[names.index(a)] for a in ax], [sizes[a] for a in ax])
            assert group == [k for k in range(4) if all(
                np.unravel_index(k, grid)[i] == coord[i]
                for i, n in enumerate(names) if n not in ax)], axis
        if "pod" in names:
            assert r["sum"] == sum(r[("pod", "data")][2])
            assert r["refused"]
        else:
            assert set(r) == {"data", "model", ("data", "model")}


class _Grid:
    """A mesh seen from the rank at `coordinate`, with no group: its
    axis sizes in order."""

    def __init__(self, sizes, coordinate):
        self.axis_sizes = dict(sizes)
        self._coordinate = tuple(coordinate)

    def size(self, axis):
        return self.axis_sizes[axis]

    def get_coordinate(self):
        return self._coordinate


def test_the_hybrid_serving_cache_on_an_undivided_grid_is_refused(J):
    """Reduced zamba2-7b (2 kv heads) on (1, 4) trains (the cell
    'zamba2-14'), but its serving cache, whose spec splits the kv heads
    over 'model', is refused; the reference cannot place it either: its
    ``device_put`` of ``cache_pspecs``' 'ak' raises ValueError."""
    from repro_torch.models import transformer

    jcfg, pcfg = _cfgs(J, "zamba2-7b", HEADS)
    model = Model(pcfg, device="cpu",
                  mesh=_Grid({"data": 1, "model": 4}, (0, 1)))
    assert model.tp.kv_heads is False
    with pytest.raises(NotImplementedError, match="cannot place"):
        model.cache_template(4, 32)
    with pytest.raises(NotImplementedError, match="cannot place"):
        transformer._serving_on_mesh(pcfg, model.tp)
    jm = J.Model(jcfg, mesh=_mesh(J, (1, 4)), param_dtype=J.jnp.float32)
    shape = J.Shape("s", "decode", 32, 4)
    spec = jm.cache_pspecs(shape)["ak"]
    ak = jm.cache_template(4, 32)["ak"]
    with pytest.raises(ValueError, match="divisible"):
        J.jax.device_put(np.zeros(ak.shape, np.float32),
                         J.jax.sharding.NamedSharding(jm.mesh, spec))


def test_rank_rows_cut_over_the_pod_axis_in_the_reference_order():
    """Over ('pod', 'data') a rank's block is pod x data-size +
    data-rank, over ('pod', 'data', 'model') that x model-size +
    model-rank, and over ('pod',) (the fall-back) the pod alone."""
    cfg = reduced_config(get_config("mamba2-130m"))
    batch = {"tokens": torch.arange(8)[:, None].expand(8, 3)}
    sizes = {"pod": 2, "data": 2, "model": 2}
    got = {}
    for o in range(2):
        for p in range(2):
            for q in range(2):
                model = types.SimpleNamespace(cfg=cfg, mesh=_Grid(
                    sizes, (o, p, q)))
                got[o, p, q] = [
                    port_train.rank_rows(model, None, batch, axes)[
                        "tokens"][:, 0].tolist()
                    for axes in (("pod", "data"), ("pod", "data", "model"),
                                 ("pod",))]
    for (o, p, q), (two, three, pod) in got.items():
        assert two == [4 * o + 2 * p, 4 * o + 2 * p + 1]
        assert three == [4 * o + 2 * p + q]
        assert pod == list(range(4 * o, 4 * o + 4))
