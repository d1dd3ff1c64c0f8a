"""The SSM and hybrid families over a (data x model) mesh of ranks: the
reference's three layouts of the SSM heads and rows, trained and served on
4 spawned CPU ranks over gloo, against the JAX package and against the
port's own one-device step.

One spawn runs every rank job the tests read (``testing.multiprocess.
rank_lm``), at reduced mamba2-130m (8 SSM heads of 16) and reduced
zamba2-7b (8 SSM heads; its shared block at 16 q heads of 16 over 2 kv
heads, so that no head is padded: the reference's padded heads train,
ROADMAP C5), and at a mamba2 of 6 heads (d_model 48), which a model axis
of 4 does not divide. JAX runs only in the parent, on a
``jax.sharding.Mesh`` of 4 of the host devices that ``tests/conftest.py``
forces, while the ranks run.

The layouts (``sharding_rules.rules_for``, ``batch_axes``):

* A: the heads over 'model', the rows over 'data' (mamba2 at batch 2,
  zamba2 always): each rank runs its heads;
* B: the heads over 'model', the rows over ('data', 'model') (mamba2 at
  batch 4): each rank runs its rows on every head, the split leaves
  gathered;
* C: the heads replicated (6 heads on (1, 4)), the rows over 'model' at
  batch 4, over 'data' alone at batch 2.

Policies:

* the (2, 2) train step (adamw, ZeRO-1, remat "collectives", 2 steps) in
  A and B, and zamba2's with 2 micro-batches, against the reference's
  ``jit_train_step`` on a 2 x 2 mesh: loss and grad norm to
  F32_REDUCTION, the parameters after each step to UPDATE_TOL x the
  reference's largest update of the leaf (at most ADAMW_FLIPS of a leaf's
  elements outside, as ``tests/test_torch_mesh_lm.py`` holds adamw).
  zamba2 takes batch 4 there: at batch 2 with 2 micro-batches the
  reference's grad norm is NaN (a one-row micro-batch over a 'data' axis
  of 2; ROADMAP C11);
* ZeRO-1's gathered state and parameters after the first step BITWISE an
  unsharded update from the same summed gradients;
* remat "collectives" BITWISE "none" with the same collectives, and
  "full" with more;
* the gradients on (2, 2) and (1, 4), and C's on (1, 4), within GRAD_TOL
  of each leaf's largest entry of the one-device port's; three controls
  outside that rule: the gated norm's backward all-reduce dropped and
  the replicated B/C weights' partial gradients unsummed (A), a gathered
  leaf's gradient not reduce-scattered (B, and C's vocabulary);
* serving (``warm_up``, then greedy decode) and ``serve`` itself on
  (2, 2), and C's on (1, 4): every step's logits within SERVE_TOL (rtol =
  atol) of the one-device port's, the greedy tokens identical, each
  rank's cache the shape ``cache_pspecs`` gives and its conv history the
  one-device cache's rows; zamba2's ring decode (a cache past 2 x its
  window of 8) under ``long_context`` too.
"""
import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import Model
from repro_torch.models import params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.testing import multiprocess as mp
from repro_torch.testing.tolerances import F32_REDUCTION

UNPADDED = dict(num_heads=16, num_kv_heads=2, head_dim=16)
UPDATE_TOL, ADAMW_FLIPS = 2e-3, 1e-3
GRAD_TOL = 1e-4  # of each leaf's largest entry
SERVE_TOL = 2e-4
S, LR, STEPS = 16, 3e-3, 2
PROMPT, GEN, RING = 12, 4, 20  # RING > 2 x zamba2's window of 8
REMATS = ("none", "collectives", "full")
# (model, batch, micro-batches): the cells held to the reference
CELLS = {"mamba2-A": ("mamba2", 2, 1), "mamba2-B": ("mamba2", 4, 1),
         "zamba2-A": ("zamba2", 4, 2)}
CONTROLS = {"mamba2-A": ("norm_grad", "bc_grad"),
            "mamba2-B": ("scatter_grad",),
            "zamba2-A": ("norm_grad", "bc_grad")}


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
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=jax_get_config,
        reduced_config=jax_reduced_config, Shape=JaxShape,
        tokens=jax_tokens, train=jax_train, Model=JaxModel)


def _cfgs(J, arch, extra):
    return (dataclasses.replace(J.reduced_config(J.get_config(arch)),
                                **extra),
            dataclasses.replace(reduced_config(get_config(arch)), **extra))


def _batches(J, cfg, B):
    return [{k: np.asarray(v) for k, v in J.tokens.synthetic_token_batch(
        0, step, B, S, cfg.vocab_size).items()} for step in range(STEPS)]


def _jobs(cfg, cells, prompts):
    """The rank jobs of one model: per cell the train steps and the
    gradients under each remat and control; (1, 4) gradients; serving."""
    lm = []
    for name, (batches, A) in cells.items():
        lm.append(dict(kind="train", grid=(2, 2), remat="collectives",
                       tag=name, batches=batches, settings=dict(
                           optimizer="adamw", lr=LR, zero1=True,
                           accum_steps=A)))
        lm += [dict(kind="grads", grid=(2, 2), remat=r, tag=name,
                    batch=batches[0]) for r in REMATS]
        lm += [dict(kind="grads", grid=(2, 2), tag=name, batch=batches[0],
                    controls=(c,)) for c in CONTROLS[name]]
        if cfg.family == "ssm":
            lm.append(dict(kind="grads", grid=(1, 4), tag=name,
                           batch=batches[0]))
    lm += [dict(kind=kind, grid=(2, 2), prompts=prompts, gen_len=GEN)
           for kind in ("serve", "serve_call")]
    if cfg.family == "hybrid":
        lm.append(dict(kind="serve", grid=(2, 2), prompts=prompts,
                       gen_len=GEN, cache_len=RING, long_context=True))
    return lm


def _c_jobs(cfg, batches, prompts):
    """The replicated heads (C): gradients with the rows over 'model'
    (batch 4) and over 'data' alone (batch 2), the vocabulary gather's
    control, serving on (1, 4)."""
    lm = [dict(kind="grads", grid=(1, 4), tag=f"C{len(b['tokens'])}",
               batch=b) for b in batches]
    lm.append(dict(kind="grads", grid=(1, 4), tag="C4", batch=batches[0],
                   controls=("scatter_grad",)))
    lm.append(dict(kind="serve", grid=(1, 4), prompts=prompts, gen_len=GEN))
    return lm


def _reference_steps(J, d):
    """Per cell, the reference's ``jit_train_step`` on a 2 x 2 mesh
    (compiled once): each step's loss and grad norm and the parameters
    before and after it."""
    devs = np.array(J.jax.devices()[:4]).reshape(2, 2)
    mesh = J.jax.sharding.Mesh(devs, ("data", "model"))
    out = {}
    for name, (batches, A) in d["cells"].items():
        jm = J.Model(d["jcfg"], mesh=mesh, param_dtype=J.jnp.float32,
                     remat="none")
        settings = J.train.TrainSettings(optimizer="adamw", lr=LR,
                                         zero1=True, accum_steps=A)
        shape = J.Shape("t", "train", S, len(batches[0]["tokens"]))
        jstep, jopt, (_, _, param_sh, opt_sh, batch_sh) = \
            J.train.jit_train_step(jm, shape, settings)
        jp = J.jax.device_put(d["tree"], param_sh)
        js = J.jax.jit(jopt.init, out_shardings=opt_sh)(jp)
        steps = []
        for step, batch in enumerate(batches):
            old = [np.asarray(a) for a in J.jax.tree.leaves(jp)]
            jp, js, jmet = jstep(jp, js, J.jax.device_put(batch, batch_sh),
                                 J.jnp.int32(step))
            steps.append(dict(
                loss=float(jmet["loss"]), grad_norm=float(jmet["grad_norm"]),
                old=old, new=[np.asarray(a) for a in J.jax.tree.leaves(jp)]))
        out[name] = steps
    return out


@pytest.fixture(scope="module")
def setup(J):
    """Per model: the configs, the reference's parameters (numpy), the
    cells' batches; one spawn of 4 CPU ranks for every rank job, run
    while the reference's steps compile and run here."""
    models = {"mamba2": ("mamba2-130m", {}),
              "zamba2": ("zamba2-7b", UNPADDED),
              "mamba2-C": ("mamba2-130m", dict(d_model=48))}
    out, jobs = {}, []
    for i, (key, (arch, extra)) in enumerate(models.items()):
        jcfg, pcfg = _cfgs(J, arch, extra)
        jm = J.Model(jcfg, mesh=None, param_dtype=J.jnp.float32)
        tree = J.jax.tree.map(np.asarray, jm.init(J.jax.random.PRNGKey(i)))
        prompts = np.random.default_rng(7 + i).integers(
            0, pcfg.vocab_size, (4, PROMPT)).astype(np.int64)
        cells = {name: (_batches(J, pcfg, B), A)
                 for name, (m, B, A) in CELLS.items() if m == key}
        if key == "mamba2-C":
            lm = _c_jobs(pcfg, [_batches(J, pcfg, B)[0] for B in (4, 2)],
                         prompts)
        else:
            lm = _jobs(pcfg, cells, prompts)
        jobs.append((mp.rank_lm, (pcfg, tree, lm, "cpu")))
        out[key] = dict(jcfg=jcfg, pcfg=pcfg, tree=tree, cells=cells,
                        prompts=prompts, lm=lm)
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
        refs = {key: _reference_steps(J, d) for key, d in out.items()
                if d["cells"]}
    finally:
        ranks.join()
    if "error" in done:
        raise done["error"]
    launch = done["launch"]
    assert launch.exit_codes == {}, launch.errors
    for i, key in enumerate(out):
        out[key]["ranks"] = [r[i] for r in launch.results]
        out[key]["ref"] = refs.get(key, {})
    return out


def _matches(job, field, value):
    got = job.get(field)
    if field == "controls":
        return tuple(got or ()) == tuple(value or ())
    return got == value


def _job(d, kind, grid, **match):
    """Every rank's result of the first job of `kind` on `grid` whose
    fields are `match` (an absent field matches None)."""
    for k, job in enumerate(d["lm"]):
        if job["kind"] == kind and tuple(job["grid"]) == grid and all(
                _matches(job, f, v) for f, v in match.items()):
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


def _model(cell):
    return CELLS[cell][0]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_train_step_matches_reference_jit_train_step(setup, cell):
    d = setup[_model(cell)]
    res = _job(d, "train", (2, 2), tag=cell)
    for r in res[1:]:  # every rank gathers the same trees
        assert all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(r["params"][-1]), tree_leaves(res[0]["params"][-1])))
    got = res[0]
    for step, ref in enumerate(d["ref"][cell]):
        for key in ("loss", "grad_norm"):
            w = ref[key]
            assert abs(got["metrics"][step][key] - w) <= \
                F32_REDUCTION.obj_rel * w, (step, key)
        for j0, j1, p1 in zip(ref["old"], ref["new"],
                              tree_leaves(got["params"][step])):
            bound = UPDATE_TOL * np.abs(j1 - j0).max()
            missed = float((np.abs(p1 - j1) > bound).mean())
            assert missed <= ADAMW_FLIPS, (step, j1.shape, missed)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_zero1_state_is_bitwise_an_unsharded_update(setup, cell):
    got = _job(setup[_model(cell)], "train", (2, 2), tag=cell)[0]
    ref = got["unsharded"]
    for a, b in zip(tree_leaves(got["gathered_state"]),
                    tree_leaves(ref["state"])):
        assert np.array_equal(a, b)
    for a, b in zip(tree_leaves(got["params"][0]),
                    tree_leaves(ref["params"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_remat_collectives_is_bitwise_none_and_full_has_more(setup, cell):
    d = setup[_model(cell)]
    runs = {r: _job(d, "grads", (2, 2), tag=cell, remat=r, controls=None)[0]
            for r in REMATS}
    none, coll, full = (runs[r] for r in REMATS)
    assert coll["loss"] == none["loss"]
    assert all(np.array_equal(a, b) for a, b in zip(
        tree_leaves(coll["grads"]), tree_leaves(none["grads"])))
    assert coll["calls"] == none["calls"]
    assert sum(full["calls"].values()) > sum(none["calls"].values())


# zamba2's 2 kv heads do not divide a model axis of 4: its hybrid cache
# could not lie there, so that grid is refused (test_torch_mesh_lm.py)
GRIDS = [(c, g) for c in sorted(CELLS) for g in ((2, 2), (1, 4))
         if g == (2, 2) or CELLS[c][0] == "mamba2"]


@pytest.mark.parametrize("cell,grid", GRIDS)
def test_mesh_gradients_match_one_device(setup, cell, grid):
    d = setup[_model(cell)]
    batch = d["cells"][cell][0][0]
    loss, want = _one_device(d, batch)
    for r in _job(d, "grads", grid, tag=cell, controls=None):
        assert abs(r["loss"] - loss) <= F32_REDUCTION.obj_rel * loss
        assert not _grad_misses(r["grads"], want), (grid, r["calls"])


@pytest.mark.parametrize("cell,control", [(c, x) for c in sorted(CELLS)
                                          for x in CONTROLS[c]]
                         + [("C4", "scatter_grad")])
def test_controls_fall_outside_the_gradient_rule(setup, cell, control):
    """Each control's gradient misses the rule somewhere: the gated
    norm's backward all-reduce dropped, the B/C weights' partial
    gradients unsummed (A), a gathered leaf keeping its own slice of its
    own gradient (B's SSM and vocabulary leaves, C's vocabulary)."""
    if cell == "C4":
        d = setup["mamba2-C"]
        grid, batch = (1, 4), _c_batch(d, cell)
    else:
        d, grid = setup[_model(cell)], (2, 2)
        batch = d["cells"][cell][0][0]
    _, want = _one_device(d, batch)
    got = _job(d, "grads", grid, tag=cell, controls=(control,))[0]
    assert _grad_misses(got["grads"], want), control


def _c_batch(d, tag):
    return next(j["batch"] for j in d["lm"] if j.get("tag") == tag)


def test_the_layouts_run_their_collectives(setup):
    """A runs the heads tensor-parallel, B gathers the split leaves and
    the vocabulary and sums the replicated leaves over 'model' too."""
    a = _job(setup["mamba2"], "grads", (2, 2), tag="mamba2-A", remat="none",
             controls=None)[0]["calls"]
    b = _job(setup["mamba2"], "grads", (2, 2), tag="mamba2-B", remat="none",
             controls=None)[0]["calls"]
    L = setup["mamba2"]["pcfg"].num_layers
    assert a["ssm_norm"] == 2 * L and a["ssm_out"] == L
    assert a["ssm_bc_grad"] == 4 * L and a["ssm_in"] == L
    assert "ssm_weights" not in a and "vocab_weights" not in a
    # 9 split leaves a layer, gathered and reduce-scattered
    assert b["ssm_weights"] == 2 * 9 * L and b["vocab_weights"] == 2
    assert not {"ssm_norm", "ssm_out", "embed", "ce"} & set(b)


@pytest.mark.parametrize("tag", ["C4", "C2"])
def test_replicated_heads_match_one_device(setup, tag):
    """C on (1, 4): 6 heads, which 4 ranks do not divide, replicated;
    batch 4 lays the rows over 'model' (the vocabulary gathered), batch 2
    leaves them whole on every rank (the vocabulary tensor-parallel)."""
    d = setup["mamba2-C"]
    res = _job(d, "grads", (1, 4), tag=tag, controls=None)
    loss, want = _one_device(d, _c_batch(d, tag))
    for r in res:
        assert abs(r["loss"] - loss) <= F32_REDUCTION.obj_rel * loss
        assert not _grad_misses(r["grads"], want)
    calls = res[0]["calls"]
    assert not {"ssm_norm", "ssm_out", "ssm_weights"} & set(calls)
    assert ("vocab_weights" in calls) == (tag == "C4")


def _one_device_serving(model, params, prompts, tokens, cache_len,
                        long_context=False):
    """The one-device port's logits (B, GEN, Vp) for `prompts` fed the
    greedy `tokens`, and its cache: the prefill's, then ``warm_up``'s
    decode state and GEN - 1 decode steps."""
    prefill, decode = port_serve.make_serve_steps(model)
    with torch.no_grad():
        logits, _ = prefill(params, {"tokens": prompts})
        B, P = prompts.shape
        _, cache = port_serve.warm_up(model, params, prompts,
                                      model.cache_template(B, cache_len))
        out = [logits]
        for i in range(GEN - 1):
            pos = torch.full((B,), P + i, dtype=torch.long)
            logits, cache = model.decode(params, cache, tokens[:, i:i + 1],
                                         pos, long_context=long_context)
            out.append(logits)
    return torch.stack(out, 1).numpy(), cache


SERVES = {"mamba2": ((2, 2), {}), "zamba2": ((2, 2), {}),
          "zamba2-ring": ((2, 2), dict(cache_len=RING, long_context=True)),
          "mamba2-C": ((1, 4), {})}


@pytest.mark.parametrize("name", sorted(SERVES))
def test_mesh_serving_matches_one_device(setup, name):
    key = name.replace("-ring", "")
    d = setup[key]
    grid, opts = SERVES[name]
    cfg = d["pcfg"]
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    prompts = torch.from_numpy(d["prompts"])
    B = prompts.shape[0]
    cache_len = opts.get("cache_len", PROMPT + GEN)
    res = _job(d, "serve", grid, cache_len=opts.get("cache_len"),
               long_context=opts.get("long_context"))
    layout = Model(cfg, device="cpu", mesh=dict(zip(("data", "model"),
                                                    grid)))
    specs = layout.cache_pspecs(ShapeConfig("s", "decode", cache_len, B))
    whole = model.cache_template(B, cache_len, device="meta")
    sizes = dict(zip(("data", "model"), grid))
    want = {k: tuple(n // (sizes[a] if a else 1)
                     for n, a in zip(whole[k].shape, specs[k]))
            for k in whole}
    rows = B // grid[0]
    if cfg.family == "hybrid":
        assert specs["ak"][3] == "model"
        assert whole["ak"].shape[2] == (cfg.sliding_window if "ring" in name
                                        else cache_len)
    for r in res:
        p = r["coordinate"][0]
        mine = slice(p * rows, (p + 1) * rows)
        assert r["cache_shapes"] == want, r["coordinate"]
        ref, cache = _one_device_serving(
            model, params, prompts[mine], torch.from_numpy(r["tokens"]),
            cache_len, opts.get("long_context", False))
        assert np.allclose(r["logits"], ref, rtol=SERVE_TOL, atol=SERVE_TOL)
        # the one-device decode, fed the rank's tokens, picks each of them
        assert np.array_equal(ref.argmax(-1), r["tokens"])
        assert np.allclose(r["conv"], cache["conv"].numpy(), rtol=SERVE_TOL,
                           atol=SERVE_TOL)
        if grid[1] > 1 and cfg.ssm_heads % grid[1] == 0:
            assert "ssm_conv" in r["decode_calls"]
    tokens, _ = port_serve.serve(model, params, prompts, GEN)
    for r in res:
        p = r["coordinate"][0]
        if "ring" not in name:
            assert np.array_equal(r["tokens"],
                                  tokens[p * rows:(p + 1) * rows].numpy())


@pytest.mark.parametrize("key", ["mamba2", "zamba2"])
def test_serve_call_matches_one_device(setup, key):
    """``serve.serve`` itself over the mesh: the rank's rows (the cache's,
    over 'data') get the one-device port's tokens and prefill logits."""
    d = setup[key]
    model = Model(d["pcfg"], device="cpu", param_dtype=torch.float32)
    params = port_params.from_numpy(d["tree"], device="cpu")
    prompts = torch.from_numpy(d["prompts"])
    tokens, logits = port_serve.serve(model, params, prompts, GEN)
    rows = prompts.shape[0] // 2
    for r in _job(d, "serve_call", (2, 2)):
        p = r["coordinate"][0]
        mine = slice(p * rows, (p + 1) * rows)
        assert np.array_equal(r["tokens"], tokens[mine].numpy())
        assert np.allclose(r["logits"], logits[mine].numpy(),
                           rtol=SERVE_TOL, atol=SERVE_TOL)


class _Grid:
    """A (data, model) grid seen from a rank, with no group."""

    def __init__(self, data, model, q=0):
        self.axis_sizes = {"data": data, "model": model}
        self._q = q

    def size(self, axis):
        return self.axis_sizes[axis]

    def get_coordinate(self):
        return (0, self._q)


def test_tensor_parallel_reads_the_ssm_layouts():
    """The heads are split where the rules split them; the rows lie over
    'model' where the step's activation spec puts them."""
    from repro_torch.distributed.sharding_rules import activation_pspec_fn
    from repro_torch.distributed.tensor_parallel import TensorParallel

    m = reduced_config(get_config("mamba2-130m"))
    six = dataclasses.replace(m, d_model=48)
    assert TensorParallel(_Grid(2, 2), m).ssm_heads
    assert not TensorParallel(_Grid(1, 4), six).ssm_heads
    tp = TensorParallel(_Grid(2, 2), m)
    for B, over in ((2, False), (4, True)):
        fn = activation_pspec_fn(m, ShapeConfig("t", "train", S, B),
                                 {"data": 2, "model": 2})
        assert tp.rows_over_model(fn) is over
    assert not tp.rows_over_model(None)
    z = dataclasses.replace(reduced_config(get_config("zamba2-7b")),
                            **UNPADDED)
    fn = activation_pspec_fn(z, ShapeConfig("t", "train", S, 4),
                             {"data": 2, "model": 2})
    assert not TensorParallel(_Grid(2, 2), z).rows_over_model(fn)


def test_rank_rows_cut_over_both_axes_in_the_reference_order():
    """Over ('data', 'model') a rank's block is data-rank x model-size +
    model-rank, as a dim split over the two axes lies."""
    cfg = reduced_config(get_config("mamba2-130m"))
    batch = {"tokens": torch.arange(8)[:, None].expand(8, 3)}
    shape = ShapeConfig("t", "train", 3, 8)
    got = {}
    for p in range(2):
        for q in range(2):
            model = types.SimpleNamespace(
                cfg=cfg, mesh=types.SimpleNamespace(
                    axis_sizes={"data": 2, "model": 2},
                    size=lambda ax: 2, get_coordinate=lambda p=p, q=q: (p, q)))
            got[p, q] = port_train.rank_rows(model, shape, batch)[
                "tokens"][:, 0].tolist()
    assert got == {(0, 0): [0, 1], (0, 1): [2, 3], (1, 0): [4, 5],
                   (1, 1): [6, 7]}
