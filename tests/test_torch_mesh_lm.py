"""The LM stack over a (data x model) mesh of ranks: the port's
tensor-parallel and ZeRO-1 step and its two decodes, on 4 spawned CPU
ranks over gloo, against the JAX package and against the port's own
one-device step.

One spawn runs every rank job the tests read (``testing.multiprocess.
rank_lm``), at reduced chatglm3-6b (2 kv heads: split at model 2,
replicated at model 4, where ranks 0-1 read kv head 0 and ranks 2-3 kv
head 1) and reduced gemma2-9b (a window of 8, attention and final
softcaps, tied embeddings), both at 16 q heads of 16 so that no head is
padded (the reference's padded heads train, ROADMAP C5). JAX runs only in
the parent, on a ``jax.sharding.Mesh`` of 4 of the host devices that
``tests/conftest.py`` forces.

Policies:

* the (2, 2) train step (adamw, ZeRO-1, remat "collectives", 3 steps)
  against the reference's ``jit_train_step`` on a 2 x 2 mesh: loss and
  grad norm to F32_REDUCTION, the parameters after each step to
  UPDATE_TOL x the reference's largest update of the leaf (at most
  ADAMW_FLIPS of a leaf's elements outside, as
  ``tests/test_torch_train_moe.py`` holds adamw);
* ZeRO-1's gathered state and parameters after the first step BITWISE an
  unsharded update from the same summed gradients;
* remat "collectives" BITWISE "none" on the same mesh, with the same
  all-reduces, and "full" with more;
* the gradients on (2, 2) and (1, 4) within GRAD_TOL of each leaf's
  largest entry of the one-device port's; two controls outside that rule:
  the input collective's backward all-reduce dropped (2, 2), the
  replicated kv weights' partial gradients left unsummed (1, 4);
* ``decode_attn_seq`` on (1, 4) against the reference's
  ``decode_attn_seq`` on a 1 x 4 mesh, with and without a window, to
  F32_REDUCTION (the output and the cache);
* serving on (1, 4) ('seq' decode) and (2, 2) ('heads'): every step's
  logits within SERVE_TOL (rtol = atol) of the one-device port's, the
  greedy tokens identical, each rank's cache the shape ``cache_pspecs``
  gives.
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

ARCHS = ("chatglm3-6b", "gemma2-9b")
UNPADDED = dict(num_heads=16, num_kv_heads=2, head_dim=16)
UPDATE_TOL, ADAMW_FLIPS = 2e-3, 1e-3
GRAD_TOL = 1e-4  # of each leaf's largest entry
SERVE_TOL = 2e-4
TRAIN_B, TRAIN_S, TRAIN_LR, STEPS = 4, 16, 3e-3, 3
PROMPT, GEN = 12, 4
SEQ_B, SEQ_S, SEQ_POS = 2, 16, 9  # decode_attn_seq: pos 9 in rank 2's chunk
REMATS = ("none", "collectives", "full")
GRIDS = {"heads": (2, 2), "seq": (1, 4)}


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.data import tokens as jax_tokens
    from repro.launch import train as jax_train
    from repro.models import Model as JaxModel
    from repro.models import attention as jax_attention
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Shape=JaxShape,
        tokens=jax_tokens, train=jax_train, Model=JaxModel,
        attention=jax_attention)


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


def _seq_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    kv = (SEQ_B, SEQ_S, cfg.num_kv_heads, cfg.resolved_head_dim)
    return dict(h=rng.normal(size=(SEQ_B, 1, cfg.d_model)).astype(np.float32),
                cache_k=rng.normal(size=kv).astype(np.float32),
                cache_v=rng.normal(size=kv).astype(np.float32),
                pos=np.full((SEQ_B,), SEQ_POS, np.int32))


@pytest.fixture(scope="module")
def setup(J):
    """Per arch: the configs, the reference's parameters (numpy) and the
    batches; then one spawn of 4 CPU ranks for every rank job."""
    out = {}
    jobs = []
    for i, arch in enumerate(ARCHS):
        jcfg, pcfg = _cfgs(J, arch)
        jm = J.Model(jcfg, mesh=None, param_dtype=J.jnp.float32)
        tree = J.jax.tree.map(np.asarray, jm.init(J.jax.random.PRNGKey(i)))
        batches = _batches(J, pcfg)
        prompts = np.random.default_rng(7 + i).integers(
            0, pcfg.vocab_size, (TRAIN_B, PROMPT)).astype(np.int64)
        lm = [dict(kind="train", grid=(2, 2), remat="collectives",
                   settings=dict(optimizer="adamw", lr=TRAIN_LR, zero1=True),
                   batches=batches)]
        lm += [dict(kind="grads", grid=(2, 2), remat=r, batch=batches[0])
               for r in REMATS]
        lm += [dict(kind="grads", grid=(2, 2), batch=batches[0],
                    controls=("input_grad",)),
               dict(kind="grads", grid=(1, 4), batch=batches[0]),
               dict(kind="grads", grid=(1, 4), batch=batches[0],
                    controls=("kv_grad",))]
        lm += [dict(kind=kind, grid=grid, prompts=prompts, gen_len=GEN)
               for grid in GRIDS.values() for kind in ("serve", "serve_call")]
        attn = {k: v[0] for k, v in tree["layers"]["attn"].items()}
        seq = [dict(kind="decode_seq", grid=(1, 4), window=w,
                    **_seq_inputs(pcfg, 20 + i))
               for w in (0, pcfg.sliding_window or 5)]
        jobs += [(mp.rank_lm, (pcfg, tree, lm, "cpu")),
                 (mp.rank_lm, (pcfg, attn, seq, "cpu"))]
        out[arch] = dict(jcfg=jcfg, pcfg=pcfg, tree=tree, batches=batches,
                         prompts=prompts, attn=attn, seq=seq, lm=lm)
    launch = mp.launch_coordinated(mp.rank_batch, 4, (jobs,),
                                   backend="gloo", timeout=300)
    assert launch.exit_codes == {}, launch.errors
    for i, arch in enumerate(ARCHS):
        out[arch]["ranks"] = [r[2 * i] for r in launch.results]
        out[arch]["seq_ranks"] = [r[2 * i + 1] for r in launch.results]
    return out


def _job(d, kind, grid, **match):
    """Every rank's result of the first job of `kind` on `grid` whose
    fields are `match`."""
    for k, job in enumerate(d["lm"]):
        if job["kind"] == kind and tuple(job["grid"]) == grid and all(
                job.get(f) == v for f, v in match.items()):
            return [r[k] for r in d["ranks"]]
    raise KeyError((kind, grid, match))


def _one_device(d, batch):
    model = Model(d["pcfg"], device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    loss, _, grads = port_train.loss_and_grads(
        model, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), [g.numpy() for g in tree_leaves(grads)]


def _grad_misses(got, want):
    """Leaves (by index) outside GRAD_TOL of the leaf's largest entry."""
    return [i for i, (a, b) in enumerate(zip(tree_leaves(got), want))
            if np.abs(a - b).max() > GRAD_TOL * np.abs(b).max()]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_jit_train_step(J, setup, arch):
    d = setup[arch]
    jm = J.Model(d["jcfg"], mesh=_mesh(J, (2, 2)), param_dtype=J.jnp.float32,
                 remat="none")
    settings = J.train.TrainSettings(optimizer="adamw", lr=TRAIN_LR,
                                     zero1=True)
    shape = J.Shape("t", "train", TRAIN_S, TRAIN_B)
    jstep, jopt, (_, _, param_sh, opt_sh, batch_sh) = \
        J.train.jit_train_step(jm, shape, settings)
    jp = J.jax.device_put(d["tree"], param_sh)
    js = J.jax.jit(jopt.init, out_shardings=opt_sh)(jp)
    res = _job(d, "train", (2, 2))
    for r in res[1:]:  # every rank gathers the same trees
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(r["params"][-1]), tree_leaves(res[0]["params"][-1])))
    got = res[0]
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
            assert missed <= ADAMW_FLIPS, (step, j1.shape, missed)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_state_is_bitwise_an_unsharded_update(setup, arch):
    got = _job(setup[arch], "train", (2, 2))[0]
    ref = got["unsharded"]
    for a, b in zip(tree_leaves(got["gathered_state"]),
                    tree_leaves(ref["state"])):
        assert np.array_equal(a, b)
    for a, b in zip(tree_leaves(got["params"][0]),
                    tree_leaves(ref["params"])):
        assert np.array_equal(a, b)


def _all_reduces(calls):
    return sum(calls.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_collectives_is_bitwise_none_with_no_extra_all_reduce(setup,
                                                                    arch):
    d = setup[arch]
    runs = {r: _job(d, "grads", (2, 2), remat=r, controls=None)[0]
            for r in REMATS}
    none, coll, full = (runs[r] for r in REMATS)
    assert coll["loss"] == none["loss"]
    assert all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(coll["grads"]), tree_leaves(none["grads"])))
    assert coll["calls"] == none["calls"]
    assert _all_reduces(full["calls"]) > _all_reduces(none["calls"])
    # two forward all-reduces a layer, recomputed under "full" only
    L = d["pcfg"].num_layers
    assert full["calls"]["attn_out"] == none["calls"]["attn_out"] + L


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_gradients_match_one_device_and_controls_miss(setup, arch):
    d = setup[arch]
    loss, want = _one_device(d, d["batches"][0])
    for grid in GRIDS.values():
        got = _job(d, "grads", grid, controls=None)[0]
        assert abs(got["loss"] - loss) <= F32_REDUCTION.obj_rel * loss
        assert not _grad_misses(got["grads"], want), grid
    for grid, control in (((2, 2), "input_grad"), ((1, 4), "kv_grad")):
        got = _job(d, "grads", grid, controls=(control,))[0]
        assert _grad_misses(got["grads"], want), (grid, control)
    # the kv weights are replicated on (1, 4) and their sum is the control's
    seq = _job(d, "grads", (1, 4), controls=None)[0]
    assert seq["calls"]["kv_grad"] == 2 * d["pcfg"].num_layers
    assert "kv_grad" not in _job(d, "grads", (2, 2), controls=None)[0][
        "calls"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attn_seq_matches_reference(J, setup, arch):
    d = setup[arch]
    mesh = _mesh(J, (1, 4))
    p = {k: J.jnp.asarray(v) for k, v in d["attn"].items()}
    for job, res in zip(d["seq"], zip(*d["seq_ranks"])):
        want, (wk, wv) = J.attention.decode_attn_seq(
            p, J.jnp.asarray(job["h"]), d["jcfg"],
            J.jnp.asarray(job["cache_k"]), J.jnp.asarray(job["cache_v"]),
            J.jnp.asarray(job["pos"]), mesh, window=job["window"])
        for r in res:
            for got, ref in ((r["out"], want), (r["cache_k"], wk),
                             (r["cache_v"], wv)):
                ref = np.asarray(ref)
                assert np.abs(got - ref).max() <= F32_REDUCTION.w_rel * \
                    max(np.abs(ref).max(), 1.0), job["window"]
    # the window matters at this position
    a, b = (np.asarray(r["out"]) for r in (d["seq_ranks"][0]))
    assert not np.allclose(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(GRIDS))
def test_mesh_serving_matches_one_device(setup, arch, mode):
    d = setup[arch]
    grid = GRIDS[mode]
    model = Model(d["pcfg"], device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    prompts = torch.from_numpy(d["prompts"])
    tokens, _ = port_serve.serve(model, params, prompts, GEN)
    res = _job(d, "serve", grid)
    B = prompts.shape[0]
    rows = B // grid[0]
    layout = Model(d["pcfg"], device="cpu", mesh=dict(
        zip(("data", "model"), grid)))
    assert layout.cache_pspecs()["k"][2 if mode == "seq" else 3] == "model"
    for r in res:
        p, q = r["coordinate"]
        mine = slice(p * rows, (p + 1) * rows)
        assert np.array_equal(r["tokens"], tokens[mine].numpy()), (p, q)
        L, KV, hd = (d["pcfg"].num_layers, d["pcfg"].num_kv_heads,
                     d["pcfg"].resolved_head_dim)
        S = PROMPT + GEN
        want_shape = (L, rows, S // 4, KV, hd) if mode == "seq" else \
            (L, rows, S, KV // grid[1], hd)
        assert r["cache_shape"] == want_shape
        # every step's logits, the one-device decode fed the same tokens
        ref = _one_device_logits(model, params, prompts[mine],
                                 torch.from_numpy(r["tokens"]))
        assert np.allclose(r["logits"], ref, rtol=SERVE_TOL, atol=SERVE_TOL)
        assert "decode_q" in r["decode_calls"] or mode == "heads"
    # serve() itself over the mesh: the same tokens and prefill logits
    for r in _job(d, "serve_call", grid):
        p = r["coordinate"][0]
        mine = slice(p * rows, (p + 1) * rows)
        assert np.array_equal(r["tokens"], tokens[mine].numpy())
        assert np.allclose(r["logits"], _one_device_logits(
            model, params, prompts[mine], torch.from_numpy(r["tokens"]))[:, 0],
            rtol=SERVE_TOL, atol=SERVE_TOL)


def _one_device_logits(model, params, prompts, tokens):
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


def test_layouts_match_what_the_ranks_hold(setup):
    """The shards the ranks run on are those of ``Model.pspecs``: the
    heads', the MLP's and the vocabulary's split over 'model'."""
    pcfg = setup["chatglm3-6b"]["pcfg"]
    specs = Model(pcfg, device="cpu", mesh={"data": 2, "model": 2}).pspecs()
    assert specs["layers"]["attn"]["wq"] == (None, None, "model", None)
    assert specs["layers"]["attn"]["wk"] == (None, None, "model", None)
    assert specs["layers"]["mlp"]["wd"] == (None, "model", None)
    assert specs["embed"] == ("model", None)
    wide = Model(pcfg, device="cpu", mesh={"data": 1, "model": 4}).pspecs()
    assert wide["layers"]["attn"]["wk"] == (None, None, None, None)


def test_a_pod_axis_and_an_undivided_hybrid_cache_refuse_a_mesh():
    """Since the 'pod' axis runs (ROADMAP A6b item 4), the one layout
    that refuses a mesh is a hybrid's serving cache on a grid whose model
    axis does not divide its kv heads: its spec splits them over 'model',
    and the reference cannot place that cache either. A (pod, data,
    model) mesh is taken by every family, for training and for serving
    (``Model`` builds its tensor parallelism, its cache shard, and
    ``transformer._serving_on_mesh`` passes). On the undivided hybrid
    grid ``Model`` builds its tensor parallelism, the kv heads replicated
    (training there is held to the reference in
    ``tests/test_torch_mesh_pod.py``); only its serving cache refuses."""
    from repro_torch.models import transformer

    def grid(sizes, coordinate):
        return types.SimpleNamespace(
            axis_sizes=sizes, size=lambda ax: sizes[ax],
            get_coordinate=lambda: coordinate)

    pod = grid({"pod": 2, "data": 1, "model": 2}, (1, 0, 1))
    for arch in ("chatglm3-6b", "arctic-480b", "mamba2-130m", "zamba2-7b"):
        cfg = reduced_config(get_config(arch))
        model = Model(cfg, device="cpu", mesh=pod)
        transformer._serving_on_mesh(cfg, model.tp)
        model.cache_template(4, 16, device="meta")
    zamba2 = reduced_config(get_config("zamba2-7b"))  # 2 kv heads
    wide = Model(zamba2, device="cpu",
                 mesh=grid({"data": 1, "model": 4}, (0, 2)))
    assert wide.tp.kv_heads is False
    with pytest.raises(NotImplementedError, match="cannot place"):
        transformer._serving_on_mesh(zamba2, wide.tp)
    with pytest.raises(NotImplementedError, match="cannot place"):
        wide.cache_template(4, 16, device="meta")


class _Grid:
    """A model axis of `size` ranks seen from `rank`, with no group."""

    def __init__(self, size, rank):
        self.axis_sizes = {"data": 1, "model": size}
        self._rank = rank

    def size(self, axis):
        return self.axis_sizes[axis]

    def get_coordinate(self):
        return (0, self._rank)


def test_kv_index_reads_the_kv_heads_of_a_ranks_q_heads():
    """chatglm3-6b on a model axis of 4: 8 of its 32 q heads a rank, all
    in one kv group of 16 (ranks 0-1 kv head 0, ranks 2-3 kv head 1); a
    layout that splits a group unevenly is refused."""
    from repro_torch.distributed.tensor_parallel import TensorParallel

    cfg = get_config("chatglm3-6b")
    got = [TensorParallel(_Grid(4, r), cfg).kv_index(cfg, 8)
           for r in range(4)]
    assert got == [slice(0, 1), slice(0, 1), slice(1, 2), slice(1, 2)]
    odd = dataclasses.replace(cfg, num_heads=96, num_kv_heads=6)
    with pytest.raises(NotImplementedError, match="unevenly"):
        TensorParallel(_Grid(4, 0), odd).kv_index(odd, 24)
