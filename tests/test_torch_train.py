"""The port's training slice against the reference's, on the CPU.

``Model.loss`` and every gradient leaf are held to the JAX package's
``jax.value_and_grad(Model.loss)`` on reduced mamba2-130m, gemma2-9b and
zamba2-7b (the reference's weights carried over with
``params.from_numpy``, Mamba-2's A_log and dt_bias set in the numpy tree
so the state carried across chunks matters, the reference's tokens, chunk
16, where the reference's gradient is finite). Each leaf is held to
F32_REDUCTION relative to its own largest entry, a stricter reading than
the policy's max(scale, 1). The reduced attention configs pad their 4 q
heads to 16: the port keeps the padded heads inert, so its wo gradient is
exactly 0 on their rows, and it is held to the reference's with those rows
masked (``testing.padded_heads``; the reference gives them a gradient,
ROADMAP C5).

``make_train_step`` is held to the reference's (built with no mesh: on
jax 0.9.0 ``make_local_mesh`` fails, ROADMAP C6) for every optimizer, 3
steps, ``accum_steps`` 1 and 2. The loss and grad-norm metrics are held to
F32_REDUCTION. The parameters after each step are held to UPDATE_TOL x the
reference's largest update of the leaf at that step: the update is the
difference of two f32 parameters of ~1 whose last bit is ~1e-7, against
updates of ~lr x |g| ~ 1e-4-1e-3, and adamw divides by sqrt(v) + eps, which
amplifies the gradients' ~1e-6 relative gap where |g| nears eps; adamw's
first step is ~lr x sign(g), so an entry whose |g| is near 0 can take the
opposite sign: a fraction ADAMW_FLIPS of its entries may miss the bound.

Then: 30 steps of reduced mamba2 reduce the loss (the reference's own
system test, ``tests/test_system.py:19``); ``remat`` changes no bit of the
gradients; the CLI runs, and a run killed two steps past its checkpoint
resumes from it bitwise; and the reference's non-finite SSM gradient at
chunk 64 (``src/repro/models/ssm.py:67``: exp of an unmasked exponent,
then inf times 0 in the backward) is pinned, beside the port's repair
(``kernels/ref.py``: the exponent masked before the exp), whose gradient
at chunk 64 equals the reference's at chunk 16 within F32_REDUCTION.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as port_train
from repro_torch.models import Model, params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.testing.padded_heads import padded_wo_gradient, unpadded
from repro_torch.testing.tolerances import F32_REDUCTION

ARCHS = ("mamba2-130m", "gemma2-9b", "zamba2-7b")
OPTIMIZERS = ("sgd", "momentum", "adamw", "adafactor")
UPDATE_TOL = 2e-3
ADAMW_FLIPS = 1e-3
TRAIN_B, TRAIN_S, TRAIN_LR = 4, 32, 3e-3


@pytest.fixture(scope="module")
def J():
    """The JAX package, imported by the tests that compare with it."""
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


def _numpy_params(J, jm, seed=0):
    """The reference's initial tree as numpy; for the SSM and hybrid
    families A_log = log U[1, 16] and dt_bias = softplus^-1(log-uniform
    [1e-3, 1e-1]) per layer and head, as Mamba-2 initialises them."""
    tree = J.jax.tree.map(lambda a: np.array(a),
                          jm.init(J.jax.random.PRNGKey(0)))
    lay = tree["layers"].get("ssm")
    if lay is not None:
        rng = np.random.default_rng(seed)
        shape = lay["A_log"].shape
        lay["A_log"] = np.log(rng.uniform(1.0, 16.0, shape)).astype(
            np.float32)
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        lay["dt_bias"] = np.log(np.expm1(dt0)).astype(np.float32)
    return tree


def _pair(J, arch, chunk=16):
    """(jax model, numpy tree, port model) of the reduced `arch`."""
    jm = J.Model(J.reduced_config(J.get_config(arch), seq_chunk=chunk),
                 mesh=None, param_dtype=J.jnp.float32)
    pm = Model(reduced_config(get_config(arch), seq_chunk=chunk),
               device="cpu", param_dtype=torch.float32)
    return jm, _numpy_params(J, jm), pm


def _jax_batch(J, step, B, S, vocab):
    return J.tokens.synthetic_token_batch(0, step, B, S, vocab)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long()
            for k, v in batch.items()}


def _jax_grads(J, jm, jp, batch):
    (loss, _), grads = J.jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(jp)
    return float(loss), [np.asarray(g) for g in J.jax.tree.leaves(grads)]


def _leaf_gaps(got, want):
    """Each leaf's max |got - want| over its own max |want|."""
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(J, arch):
    jm, tree, pm = _pair(J, arch)
    batch = _jax_batch(J, 0, 2, 32, pm.cfg.vocab_size)
    want_loss, want = _jax_grads(J, jm, J.jax.tree.map(J.jnp.asarray, tree),
                                 batch)
    loss, metrics, grads = port_train.loss_and_grads(
        pm, port_params.from_numpy(tree, device="cpu"), _torch_batch(batch))
    assert abs(float(loss) - want_loss) <= F32_REDUCTION.obj_rel * want_loss
    assert float(metrics["aux"]) == 0.0 and float(metrics["ce"]) == \
        float(loss)
    got = [g.numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in got] == [w.shape for w in want]
    # the padded heads are inert in the port: their wo rows take exactly 0,
    # and the reference's, masked, are the unpadded function's gradient
    assert padded_wo_gradient(pm.cfg, tree, got) == 0.0
    gaps = _leaf_gaps(got, unpadded(pm.cfg, tree, want))
    assert max(gaps) <= F32_REDUCTION.w_rel, gaps


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_train_step_matches_reference(J, name, accum):
    jm, tree, pm = _pair(J, "mamba2-130m")
    jstep, jopt = J.train.make_train_step(
        jm, J.Shape("t", "train", TRAIN_S, TRAIN_B),
        J.train.TrainSettings(optimizer=name, lr=TRAIN_LR,
                              accum_steps=accum, zero1=False))
    jstep = J.jax.jit(jstep)
    jp = J.jax.tree.map(J.jnp.asarray, tree)
    js = jopt.init(jp)
    pstep, popt = port_train.make_train_step(
        pm, ShapeConfig("t", "train", TRAIN_S, TRAIN_B),
        port_train.TrainSettings(optimizer=name, lr=TRAIN_LR,
                                 accum_steps=accum))
    pp = port_params.from_numpy(tree, device="cpu")
    ps = popt.init(pp)
    for step in range(3):
        batch = _jax_batch(J, step, TRAIN_B, TRAIN_S, pm.cfg.vocab_size)
        jp2, js, jmet = jstep(jp, js, batch, J.jnp.int32(step))
        pp2, ps, pmet = pstep(pp, ps, _torch_batch(batch), step)
        for key in ("loss", "ce", "grad_norm"):
            w = float(jmet[key])
            assert abs(float(pmet[key]) - w) <= F32_REDUCTION.obj_rel * w, \
                (step, key)
        for j0, j1, p1 in zip(J.jax.tree.leaves(jp), J.jax.tree.leaves(jp2),
                              tree_leaves(pp2)):
            j0, j1, p1 = np.asarray(j0), np.asarray(j1), p1.numpy()
            bound = UPDATE_TOL * np.abs(j1 - j0).max()
            missed = float((np.abs(p1 - j1) > bound).mean())
            assert missed <= (ADAMW_FLIPS if name == "adamw" else 0.0), \
                (name, step, j1.shape, missed)
        jp, pp = jp2, pp2


def test_thirty_steps_reduce_the_loss():
    """The reference's system test (tests/test_system.py:19) on the port:
    adamw at 3e-3, accum 2, 8 x 64 tokens a step, remat on."""
    cfg = reduced_config(get_config("mamba2-130m"))
    model = Model(cfg, device="cpu", param_dtype=torch.float32,
                  remat="dots")
    step_fn, opt = port_train.make_train_step(
        model, ShapeConfig("t", "train", 64, 8),
        port_train.TrainSettings(optimizer="adamw", lr=3e-3,
                                 accum_steps=2))
    params = model.init(0)
    opt_state = opt.init(params)
    pipe = TokenPipeline(seed=0, batch=8, seq_len=64,
                         vocab_size=cfg.vocab_size, device="cpu")
    losses = []
    for step in range(30):
        params, opt_state, metrics = step_fn(params, opt_state, pipe.next(),
                                             step)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit_of_the_gradients(arch):
    cfg = reduced_config(get_config(arch))
    pipe = TokenPipeline(seed=1, batch=2, seq_len=32,
                         vocab_size=cfg.vocab_size, device="cpu")
    batch = pipe.next()
    params = Model(cfg, device="cpu", param_dtype=torch.float32).init(0)
    runs = {}
    for remat in ("none", "full", "dots", "collectives"):
        model = Model(cfg, device="cpu", param_dtype=torch.float32,
                      remat=remat)
        loss, _, grads = port_train.loss_and_grads(model, params, batch)
        runs[remat] = [loss] + tree_leaves(grads)
    for remat in ("full", "dots", "collectives"):
        assert all(torch.equal(a, b)
                   for a, b in zip(runs["none"], runs[remat])), remat


def test_remat_refuses_what_it_does_not_run():
    cfg = reduced_config(get_config("mamba2-130m"))
    with pytest.raises(ValueError, match="remat"):
        Model(cfg, device="cpu", remat="everything")


class Killed(Exception):
    """An injected kill."""


def test_the_cli_trains_and_a_killed_run_resumes_bitwise(tmp_path, capsys,
                                                         monkeypatch):
    """A run killed at step 5, two steps past its step-3 checkpoint,
    resumes from step 3: the uncommitted steps 3 and 4 are taken again,
    and the run ends bitwise the uninterrupted one."""
    argv = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--log_every", "1",
            "--ckpt_every", "3", "--steps", "6"]
    straight = port_train.main(argv + ["--ckpt_dir", str(tmp_path / "a")])
    capsys.readouterr()
    make_train_step = port_train.make_train_step

    def killed_at_step_5(*args):
        step_fn, opt = make_train_step(*args)

        def step(params, opt_state, batch, t):
            if t == 5:
                raise Killed(f"injected kill at step {t}")
            return step_fn(params, opt_state, batch, t)
        return step, opt

    monkeypatch.setattr(port_train, "make_train_step", killed_at_step_5)
    with pytest.raises(Killed):
        port_train.main(argv + ["--ckpt_dir", str(tmp_path / "b")])
    monkeypatch.undo()
    assert latest_step(str(tmp_path / "b")) == 3
    out = capsys.readouterr().out
    assert "step     4" in out and "step     5" not in out
    resumed = port_train.main(argv + ["--resume", "--ckpt_dir",
                                      str(tmp_path / "b")])
    assert "resumed at step 3" in capsys.readouterr().out
    assert len(resumed.losses) == 6
    assert resumed.losses == straight.losses
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed.params), tree_leaves(straight.params)))
    assert np.isfinite(straight.losses).all()


def test_the_cli_refuses_a_resume_with_nothing_to_resume(tmp_path, capsys):
    argv = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--steps", "2", "--resume",
            "--ckpt_dir", str(tmp_path)]
    with pytest.raises(SystemExit):
        port_train.main(argv)
    assert "no committed checkpoint" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_train.main(argv + ["--optimizer", "sodda"])
    assert "keeps no checkpoint" in capsys.readouterr().err


def test_the_cli_runs_sodda_svrg():
    run = port_train.main(["--arch", "mamba2-130m", "--reduced", "--device",
                           "cpu", "--batch", "4", "--seq", "32", "--steps",
                           "3", "--optimizer", "sodda", "--lr", "0.01"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()


def test_sodda_loop_takes_the_clis_gradients():
    """At a refresh: the snapshot gradient on the d-subbatch, then the
    gradients at the parameters and at the snapshot (equal there, so the
    first update is gamma x mu); later steps take two."""
    cfg = reduced_config(get_config("mamba2-130m"))
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    calls = []
    orig = port_train.loss_and_grads

    def counting(m, params, batch):
        calls.append(batch["tokens"].shape[0])
        return orig(m, params, batch)

    port_train.loss_and_grads = counting
    try:
        pipe = TokenPipeline(seed=0, batch=4, seq_len=16,
                             vocab_size=cfg.vocab_size, device="cpu")
        _, losses = port_train.sodda_loop(model, model.init(0), pipe, 2,
                                          0.01, log=lambda _: None)
    finally:
        port_train.loss_and_grads = orig
    assert calls == [3, 4, 4, 4, 4]  # d = int(0.85 x 4)
    assert len(losses) == 2


def test_reference_ssm_gradient_is_not_finite_at_chunk_64(J):
    """The reference's fault (ROADMAP C5), pinned: at chunk 64 its
    gradient has non-finite leaves; the port's is finite, and equals the
    reference's at chunk 16 (where it is finite) within F32_REDUCTION: the
    chunk changes only the rounding."""
    jm64, tree, pm64 = _pair(J, "mamba2-130m", chunk=64)
    jm16 = J.Model(J.reduced_config(J.get_config("mamba2-130m"),
                                    seq_chunk=16), mesh=None,
                   param_dtype=J.jnp.float32)
    batch = _jax_batch(J, 0, 8, 64, pm64.cfg.vocab_size)
    jp = J.jax.tree.map(J.jnp.asarray, tree)
    _, bad = _jax_grads(J, jm64, jp, batch)
    _, want = _jax_grads(J, jm16, jp, batch)
    assert sum(not np.isfinite(g).all() for g in bad) >= 1
    assert all(np.isfinite(g).all() for g in want)
    _, _, grads = port_train.loss_and_grads(
        pm64, port_params.from_numpy(tree, device="cpu"),
        _torch_batch(batch))
    got = [g.numpy() for g in tree_leaves(grads)]
    assert all(np.isfinite(g).all() for g in got)
    gaps = _leaf_gaps(got, want)
    assert max(gaps) <= F32_REDUCTION.w_rel, gaps


def test_the_masked_exponent_leaves_the_forward_unchanged():
    """exp(where(causal, seg, -inf)) is where(causal, exp(seg), 0) bit for
    bit, overflowing seg included; its gradient is finite where the old
    form's is NaN."""
    g = torch.Generator().manual_seed(0)
    causal = torch.ones(64, 64, dtype=torch.bool).tril()
    # cum_i - cum_j: <= 0 on and below the diagonal, a large positive sum
    # above it, whose exp overflows to inf
    seg = torch.randn(64, 64, generator=g).abs() * 50.0
    seg = torch.where(causal, -seg, seg)
    seg[0, 1] = 1e4
    old = torch.where(causal, torch.exp(seg), 0.0)
    new = torch.exp(torch.where(causal, seg, -math.inf))
    assert torch.equal(old, new)
    leaf = seg.clone().requires_grad_()
    torch.where(causal, torch.exp(leaf), 0.0).sum().backward()
    assert not torch.isfinite(leaf.grad).all()
    leaf.grad = None
    torch.exp(torch.where(causal, leaf, -math.inf)).sum().backward()
    assert torch.isfinite(leaf.grad).all()


def test_plain_ssd_gradient_is_finite_at_every_chunk():
    rng = np.random.default_rng(0)
    B, S, H, P, G, N = 1, 256, 2, 16, 1, 16
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(B, S, H, P)),
        np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, S, H))),
        -rng.uniform(1.0, 16.0, H), rng.normal(size=(B, S, G, N)),
        rng.normal(size=(B, S, G, N)), np.ones(H),
        rng.normal(size=(B, S, H, P)))]
    want = ref.ssd_chunked_grads(*args, chunk=16)
    for chunk in (32, 64, 128, 256):
        got = ref.ssd_chunked_grads(*args, chunk=chunk)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all(), chunk
            assert float((g - w).abs().max()) <= \
                F32_REDUCTION.w_rel * float(w.abs().max()), chunk


@pytest.mark.gpu
def test_flash_attention_gradient_on_the_card_matches_the_plain_one():
    """A CUDA flash call whose q, k and v require grad goes through the
    forward kernel (with its log-sum-exp) and the backward kernel: one
    launch each, and every gradient within 1e-5 of its max of autograd
    through the plain version, in f32, at a gemma2-like local layer (GQA,
    window, softcap 50, unaligned S) and a zamba2-like one (D = 112)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_train.py)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, KV, S, D), opts in (
            ((2, 4, 2, 200, 256), dict(window=64, softcap=50.0)),
            ((1, 4, 4, 190, 112), dict())):
        q = torch.randn(B, S, H, D, generator=g, device="cuda")
        k = torch.randn(B, S, KV, D, generator=g, device="cuda")
        v = torch.randn(B, S, KV, D, generator=g, device="cuda")
        dout = torch.randn(B, S, H, D, generator=g, device="cuda")
        grads = []
        for force in ("auto", "ref"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            f0, b0 = ops.flash_attention.launches, \
                ops.flash_attention_bwd.launches
            out = ops.flash_attention(*leaves, force=force, **opts)
            grads.append(torch.autograd.grad(out, leaves, dout))
            if force == "auto":
                assert (ops.flash_attention.launches - f0,
                        ops.flash_attention_bwd.launches - b0) == (1, 1)
        for got, want in zip(*grads):
            assert got.dtype == want.dtype == torch.float32
            assert float((got - want).abs().max()) <= \
                1e-5 * float(want.abs().max())
