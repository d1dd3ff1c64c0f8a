"""The MoE family over a (data x model) mesh of ranks: the route over the
global batch, the 'gather' and 'token_tp' layouts, adafactor and adamw
under ZeRO-1, on 4 spawned CPU ranks over gloo, against the JAX package
and against the port's own one-device step.

One spawn runs every rank job the tests read (``testing.multiprocess.
rank_lm``), at reduced arctic-480b (8 experts top-2 with the dense
residual) and reduced kimi-k2 (8 experts top-2), both at 16 q heads of 16
over 2 kv heads, so that no head is padded (the reference's padded heads
train, ROADMAP C5). JAX runs only in the parent, on a
``jax.sharding.Mesh`` of 4 of the host devices that ``tests/conftest.py``
forces (built from the devices, not ``jax.make_mesh``: ROADMAP C6).

Policies:

* the (2, 2) train step in both layouts, with adafactor and adamw, ZeRO-1
  and remat "full", 2 steps, against the reference's ``jit_train_step``
  on a 2 x 2 mesh: loss and grad norm to F32_REDUCTION; the parameters
  after each step to UPDATE_TOL x the reference's largest update of the
  leaf (adamw: at most ADAMW_FLIPS of a leaf's elements outside, as
  ``tests/test_torch_mesh_lm.py`` holds it);
* every rank's route BITWISE ``moe.route`` of the probabilities it
  gathered, identical on every rank, and the one-device port's route of
  the same batch;
* the gradients on (2, 2), (1, 4) and (4, 1), in both layouts, within
  GRAD_TOL of each leaf's largest entry of the one-device port's, on a
  plain batch and on a skewed one of DROP_B x DROP_S tokens whose experts
  drop tokens of both data ranks; three controls outside that rule on the
  skewed batch: each data rank routing its own rows with its own
  capacity (both layouts), the gathered expert weights' gradient not
  reduce-scattered ('gather'), the 'model' all-reduce of the expert
  outputs dropped ('token_tp');
* 'gather' against 'token_tp': loss and gradients to F32_REDUCTION;
* remat "none", "full" and "collectives" BITWISE the same gradients, the
  "collectives" recompute running no collective;
* bf16 gradient accumulation (2 micro-batches) on (2, 2) within the bf16
  rounding of the one-device step's;
* serving on (2, 2) in both layouts: every step's logits within SERVE_TOL
  (rtol = atol) of the one-device port's, the greedy tokens identical.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models import params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.testing import multiprocess as mp
from repro_torch.testing.tolerances import F32_REDUCTION

ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
UNPADDED = dict(num_heads=16, num_kv_heads=2, head_dim=16)
UPDATE_TOL, ADAMW_FLIPS = 2e-3, 1e-3
GRAD_TOL = 1e-4  # of each leaf's largest entry
SERVE_TOL = 2e-4
TRAIN_B, TRAIN_S, TRAIN_LR, STEPS = 4, 16, 3e-3, 2
DROP_B, DROP_S = 4, 512  # 2048 tokens: 768 slots an expert
PROMPT, GEN = 12, 4
LAYOUTS = ("gather", "token_tp")
OPTIMIZERS = ("adafactor", "adamw")
GRIDS = ((2, 2), (1, 4), (4, 1))
REMATS = ("none", "collectives", "full")
CONTROLS = {"gather": ("local_route", "weight_grad"),
            "token_tp": ("local_route", "expert_sum")}


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.data import tokens as jax_tokens
    from repro.distributed.sharding_rules import MOE_LAYOUTS
    from repro.launch import train as jax_train
    from repro.models import Model as JaxModel
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Shape=JaxShape,
        tokens=jax_tokens, train=jax_train, Model=JaxModel,
        layouts=MOE_LAYOUTS)


def _mesh(J, grid):
    devs = np.array(J.jax.devices()[:4]).reshape(grid)
    return J.jax.sharding.Mesh(devs, ("data", "model"))


def _cfgs(J, arch):
    return (dataclasses.replace(J.reduced_config(J.get_config(arch)),
                                **UNPADDED),
            dataclasses.replace(reduced_config(get_config(arch)),
                                **UNPADDED))


def _batches(J, cfg):
    return [{k: np.asarray(v) for k, v in J.tokens.synthetic_token_batch(
        0, step, TRAIN_B, TRAIN_S, cfg.vocab_size).items()}
        for step in range(STEPS)]


def _skewed(seed, vocab=256):
    """A batch of mostly one token id: most tokens share their experts,
    which then drop tokens of both data ranks' rows."""
    rng = np.random.default_rng(seed)
    shape = (DROP_B, DROP_S + 1)
    tok = np.where(rng.random(shape) < 0.9, 0, rng.integers(0, vocab, shape))
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:]}


@pytest.fixture(scope="module")
def setup(J):
    """Per arch: the configs, the reference's parameters (numpy) and the
    batches; then one spawn of 4 CPU ranks for every rank job."""
    out, jobs = {}, []
    for i, arch in enumerate(ARCHS):
        jcfg, pcfg = _cfgs(J, arch)
        jm = J.Model(jcfg, mesh=None, param_dtype=J.jnp.float32)
        tree = J.jax.tree.map(np.asarray, jm.init(J.jax.random.PRNGKey(i)))
        batches = _batches(J, pcfg)
        skewed = _skewed(30 + i)
        prompts = np.random.default_rng(7 + i).integers(
            0, pcfg.vocab_size, (TRAIN_B, PROMPT)).astype(np.int64)
        lm = [dict(kind="train", grid=(2, 2), layout=lay, remat="full",
                   settings=dict(optimizer=o, lr=TRAIN_LR, zero1=True),
                   batches=batches)
              for lay in LAYOUTS for o in OPTIMIZERS]
        lm += [dict(kind="grads", grid=g, layout=lay, batch=batches[0])
               for lay in LAYOUTS for g in GRIDS]
        lm += [dict(kind="grads", grid=(2, 2), layout=lay, batch=skewed,
                    controls=c)
               for lay in LAYOUTS for c in ((),) + tuple(
                   (x,) for x in CONTROLS[lay])]
        if i == 0:
            lm += [dict(kind="grads", grid=(2, 2), layout=lay, remat=r,
                        batch=batches[0], tag="remat")
                   for lay in LAYOUTS for r in REMATS]
            lm += [dict(kind="grads", grid=(2, 2), layout="gather",
                        batch=batches[0], settings=dict(
                            accum_steps=2, grad_dtype="bfloat16"))]
        lm += [dict(kind="serve", grid=(2, 2), layout=lay, prompts=prompts,
                    gen_len=GEN) for lay in LAYOUTS]
        jobs.append((mp.rank_lm, (pcfg, tree, lm, "cpu")))
        out[arch] = dict(jcfg=jcfg, pcfg=pcfg, tree=tree, batches=batches,
                         skewed=skewed, prompts=prompts, lm=lm)
    launch = mp.launch_coordinated(mp.rank_batch, 4, (jobs,),
                                   backend="gloo", timeout=300)
    assert launch.exit_codes == {}, launch.errors
    for i, arch in enumerate(ARCHS):
        out[arch]["ranks"] = [r[i] for r in launch.results]
    return out


def _matches(job, field, value):
    got = job.get(field)
    if field == "batch":
        return got is value
    if field == "controls":
        return tuple(got or ()) == tuple(value)
    return got == value


def _job(d, kind, grid, **match):
    """Every rank's result of the first job of `kind` on `grid` whose
    fields are `match` (an absent field matches None; `batch` by
    identity)."""
    for k, job in enumerate(d["lm"]):
        if job["kind"] == kind and tuple(job["grid"]) == grid and all(
                _matches(job, f, v) for f, v in match.items()):
            return [r[k] for r in d["ranks"]]
    raise KeyError((kind, grid, match))


def _grads(d, grid, layout, batch, **match):
    return _job(d, "grads", grid, layout=layout, batch=batch, **match)


def _one_device(d, batch, **settings):
    """The one-device port's loss and gradients of `batch` (with
    `settings`: its accumulation); its routes kept in d["routes"]."""
    model = Model(d["pcfg"], device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if settings:
        loss, _, grads = port_train._gradients(
            model, params, batch, settings["accum_steps"],
            getattr(torch, settings["grad_dtype"]))
    else:
        with mp.routes_recorded() as seen:
            loss, _, grads = port_train.loss_and_grads(model, params, batch)
        d["routes"] = seen
    return float(loss), [g.float().numpy() for g in tree_leaves(grads)]


def _grad_misses(got, want, tol=GRAD_TOL):
    """Leaves (by index) outside `tol` of the leaf's largest entry."""
    return [i for i, (a, b) in enumerate(zip(tree_leaves(got), want))
            if np.abs(a - b).max() > tol * np.abs(b).max()]


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_jit_train_step(J, setup, arch, layout,
                                                     optimizer):
    d = setup[arch]
    jm = J.Model(d["jcfg"], mesh=_mesh(J, (2, 2)), param_dtype=J.jnp.float32,
                 remat="full", rules_overrides=J.layouts[layout])
    settings = J.train.TrainSettings(optimizer=optimizer, lr=TRAIN_LR,
                                     zero1=True, moe_layout=layout)
    shape = J.Shape("t", "train", TRAIN_S, TRAIN_B)
    jstep, jopt, (_, _, param_sh, opt_sh, batch_sh) = \
        J.train.jit_train_step(jm, shape, settings)
    jp = J.jax.device_put(d["tree"], param_sh)
    js = J.jax.jit(jopt.init, out_shardings=opt_sh)(jp)
    res = _job_train(d, layout, optimizer)
    for r in res[1:]:  # every rank gathers the same trees
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(r["params"][-1]), tree_leaves(res[0]["params"][-1])))
    got = res[0]
    flips = ADAMW_FLIPS if optimizer == "adamw" else 0.0
    for step, batch in enumerate(d["batches"]):
        old = [np.asarray(a) for a in J.jax.tree.leaves(jp)]
        jp, js, jmet = jstep(jp, js, J.jax.device_put(batch, batch_sh),
                             J.jnp.int32(step))
        for key in ("loss", "grad_norm"):
            w = float(jmet[key])
            assert abs(got["metrics"][step][key] - w) <= \
                F32_REDUCTION.obj_rel * w, (step, key)
        for j0, j1, p1 in zip(old, J.jax.tree.leaves(jp),
                              tree_leaves(got["params"][step])):
            j1 = np.asarray(j1)
            bound = UPDATE_TOL * np.abs(j1 - j0).max()
            missed = float((np.abs(p1 - j1) > bound).mean())
            assert missed <= flips, (step, j1.shape, missed)


def _job_train(d, layout, optimizer):
    for k, job in enumerate(d["lm"]):
        if job["kind"] == "train" and job["layout"] == layout and \
                job["settings"]["optimizer"] == optimizer:
            return [r[k] for r in d["ranks"]]
    raise KeyError((layout, optimizer))


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_state_is_an_unsharded_update(setup, arch):
    """ZeRO-1's gathered state and parameters after the first step:
    adamw's bitwise an unsharded update of the same summed gradients,
    adafactor's within F32_REDUCTION of it."""
    for layout in LAYOUTS:
        for opt in OPTIMIZERS:
            got = _job_train(setup[arch], layout, opt)[0]
            ref = got["unsharded"]
            for a, b in zip(tree_leaves(got["gathered_state"]) + tree_leaves(
                    got["params"][0]), tree_leaves(ref["state"])
                    + tree_leaves(ref["params"])):
                if opt == "adamw":
                    assert np.array_equal(a, b), (layout, opt)
                else:
                    assert np.abs(a - b).max() <= F32_REDUCTION.w_rel * max(
                        np.abs(b).max(), 1.0), (layout, opt)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_is_the_global_batchs_on_every_rank(setup, arch):
    d = setup[arch]
    for batch in (d["batches"][0], d["skewed"]):
        _one_device(d, batch)
        one = d["routes"]
        for layout in LAYOUTS:
            res = _grads(d, (2, 2), layout, batch, controls=())
            T = batch["tokens"].size
            for layer, rec in enumerate(res[0]["routes"]):
                assert rec["probs"].shape == (T, d["pcfg"].num_experts)
                for r in res:  # the same bits on every rank
                    mine = r["routes"][layer]
                    assert mine["again"]
                    for f in ("probs", "idx", "pos", "keep", "slots"):
                        assert np.array_equal(mine[f], rec[f]), (layer, f)
                # and the one-device port's route of the same batch
                assert np.array_equal(rec["idx"], one[layer][1].idx.numpy())
                assert np.array_equal(rec["keep"],
                                      one[layer][1].keep.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_skewed_batch_drops_tokens_of_both_data_ranks(setup, arch):
    d = setup[arch]
    rec = _grads(d, (2, 2), "gather", d["skewed"], controls=())[0][
        "routes"][0]
    k = d["pcfg"].experts_per_token
    half = DROP_B * DROP_S // 2
    dropped = ~rec["keep"].reshape(-1, k).all(1)
    assert dropped[:half].any() and dropped[half:].any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_match_one_device_and_controls_miss(setup, arch,
                                                           layout):
    d = setup[arch]
    loss, want = _one_device(d, d["batches"][0])
    for grid in GRIDS:
        got = _grads(d, grid, layout, d["batches"][0], controls=())[0]
        assert abs(got["loss"] - loss) <= F32_REDUCTION.obj_rel * loss
        assert not _grad_misses(got["grads"], want), grid
    loss, want = _one_device(d, d["skewed"])
    got = _grads(d, (2, 2), layout, d["skewed"], controls=())[0]
    assert abs(got["loss"] - loss) <= F32_REDUCTION.obj_rel * loss
    assert not _grad_misses(got["grads"], want)
    for control in CONTROLS[layout]:
        got = _grads(d, (2, 2), layout, d["skewed"],
                     controls=(control,))[0]
        assert _grad_misses(got["grads"], want), control


@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_agree(setup, arch):
    d = setup[arch]
    for batch in (d["batches"][0], d["skewed"]):
        a, b = (_grads(d, (2, 2), lay, batch, controls=())[0]
                for lay in LAYOUTS)
        assert abs(a["loss"] - b["loss"]) <= F32_REDUCTION.obj_rel * abs(
            b["loss"])
        for x, y in zip(tree_leaves(a["grads"]), tree_leaves(b["grads"])):
            assert np.abs(x - y).max() <= F32_REDUCTION.w_rel * max(
                np.abs(y).max(), 1.0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_remat_is_bitwise_and_collectives_recomputes_no_collective(
        setup, layout):
    d = setup["arctic-480b"]
    runs = {r: _job(d, "grads", (2, 2), layout=layout, tag="remat",
                    remat=r)[0] for r in REMATS}
    none = runs["none"]
    for r in REMATS[1:]:
        assert runs[r]["loss"] == none["loss"], r
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(runs[r]["grads"]), tree_leaves(none["grads"]))), r
    assert runs["collectives"]["calls"] == none["calls"]
    # "full" runs each layer's forward collectives again
    full, L = runs["full"]["calls"], d["pcfg"].num_layers
    for tag in ("moe_tokens", "moe_probs", "attn_out"):
        assert full[tag] == none["calls"][tag] + L, tag


def test_bf16_accumulation_over_the_mesh(setup):
    d = setup["arctic-480b"]
    settings = dict(accum_steps=2, grad_dtype="bfloat16")
    _, want = _one_device(d, d["batches"][0], **settings)
    got = _job(d, "grads", (2, 2), layout="gather",
               settings=settings)[0]
    assert got["grad_dtype"] == "bfloat16"
    # the sum over 'data' adds bf16 roundings (2^-8 each) to the
    # one-device accumulation's
    assert not _grad_misses(got["grads"], want, tol=2 ** -6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_serving_matches_one_device(setup, arch, layout):
    d = setup[arch]
    model = Model(d["pcfg"], device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    prompts = torch.from_numpy(d["prompts"])
    tokens, _ = port_serve.serve(model, params, prompts, GEN)
    rows = prompts.shape[0] // 2
    for r in _job(d, "serve", (2, 2), layout=layout):
        p = r["coordinate"][0]
        mine = slice(p * rows, (p + 1) * rows)
        assert np.array_equal(r["tokens"], tokens[mine].numpy())
        ref = _one_device_logits(model, params, prompts,
                                 torch.from_numpy(np.concatenate(
                                     [x["tokens"] for x in _job(
                                         d, "serve", (2, 2),
                                         layout=layout)[::2]])))[mine]
        assert np.allclose(r["logits"], ref, rtol=SERVE_TOL, atol=SERVE_TOL)
        assert r["decode_calls"]["moe_tokens"] == d["pcfg"].num_layers


def _one_device_logits(model, params, prompts, tokens):
    """The one-device port's prefill and decode logits of the whole batch
    fed `tokens` (an MoE layer routes the whole batch, as the mesh's
    does)."""
    prefill, decode = port_serve.make_serve_steps(model)
    with torch.no_grad():
        logits, pre = prefill(params, {"tokens": prompts})
        B, P = prompts.shape
        cache = port_serve.fill_cache(
            model, model.cache_template(B, P + GEN), pre, P)
        out = [logits]
        for i in range(GEN - 1):
            pos = torch.full((B,), P + i, dtype=torch.long)
            logits, cache = decode(params, cache, tokens[:, i:i + 1], pos)
            out.append(logits)
    return torch.stack(out, 1).numpy()
