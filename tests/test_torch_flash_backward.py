"""The port's flash-attention backward against the reference, on the CPU.

The reference has no backward kernel: JAX differentiates its plain
attention. So ``ref.attention_grads`` (the backward kernel's plain twin,
the FlashAttention-2 recurrence from the forward's log-sum-exp) is held to
``jax.vjp`` of the reference's ``attention_naive`` and ``attention_ref``
over a grid of every head dim in ``HEAD_DIMS`` x {causal, non-causal, a
window shorter than S with softcap 50, a query offset, a non-causal window
with softcap} at groups 1, 2 and 4 and an unaligned S of 100, each
gradient within F32_REDUCTION.w_rel of its max; and to f64 autograd
through the port's ``attention_naive`` within 1e-5 of its max, which three
controls must fail: the softcap's derivative dropped, the window dropped
from the backward's mask, and dS rounded to bf16 before the dQ and dK
products.

``_FlashAttention`` (the autograd boundary of ``ops.flash_attention`` on
the card) is wired up here with its two kernel calls monkeypatched to the
plain versions: its gradients, and reduced gemma2-9b's and zamba2-7b's
``loss_and_grads`` through it, are held to autograd through the plain
path and to JAX. The kernel's argument checks, its shared-memory budget
and its source's switch are pinned; the one test that needs the card
(marked ``gpu``) holds the kernel to the plain backward there. This
module imports JAX only inside the tests that compare with it.
"""
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import flash_attention as kernel
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as port_train
from repro_torch.models import Model, params as port_params
from repro_torch.models.params import tree_leaves
from repro_torch.testing.padded_heads import padded_wo_gradient, unpadded
from repro_torch.testing.tolerances import F32_REDUCTION, half_ulp_excess

F64_TOL = 1e-5  # against f64 autograd, of each gradient's max
F32_NOISE = 2.0 ** -18  # chip_smoke.py's bf16 rounding rule, over the max
S = 100  # unaligned: no multiple of any tile
# (id, options, group, extra keys past Sq)
MASKS = [("causal", dict(causal=True), 1, 0),
         ("noncausal", dict(causal=False), 2, 0),
         ("window40_softcap50", dict(causal=True, window=40, softcap=50.0),
          4, 0),
         ("offset7", dict(causal=True, q_offset=7), 2, 7),
         ("noncausal_window30_softcap50",
          dict(causal=False, window=30, softcap=50.0), 1, 0)]
MASK_IDS = [m[0] for m in MASKS]


@pytest.fixture(scope="module")
def J():
    """The JAX package, imported by the tests that compare with it."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.data import tokens as jax_tokens
    from repro.kernels import ref as jax_ref
    from repro.models import Model as JaxModel
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ref=jax_ref, get_config=jax_get_config,
        reduced_config=jax_reduced_config, tokens=jax_tokens, Model=JaxModel)


def _inputs(D, group, extra=0, H=4, B=2, Sq=S, seed=0):
    """q (B,Sq,H,D), k/v (B,Sq+extra,H/group,D), dout (B,Sq,H,D) as numpy
    f32, unit variance (the scores then have unit variance, as a model's
    projections of a normed residual give them)."""
    rng = np.random.default_rng(seed + D + group + extra)
    KV = H // group
    Sk = Sq + extra
    return [rng.normal(size=shape).astype(np.float32) for shape in (
        (B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D), (B, Sq, H, D))]


def _port_grads(args, **opts):
    """ref.attention_grads from ref.attention_ref's out and lse, in f32."""
    q, k, v, dout = (torch.from_numpy(a) for a in args)
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **opts)
    return ref.attention_grads(q, k, v, out, lse, dout, **opts)


def _jax_grads(J, fn, args, **opts):
    q, k, v, dout = (J.jnp.asarray(a) for a in args)
    _, vjp = J.jax.vjp(lambda q, k, v: fn(q, k, v, **opts), q, k, v)
    return [np.asarray(g) for g in vjp(dout)]


def _f64_grads(args, **opts):
    """Autograd through the port's attention_naive, in f64."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in args[:3])
    out = ref.attention_naive(q, k, v, **opts)
    return torch.autograd.grad(out, (q, k, v),
                               torch.from_numpy(args[3]).double())


def _gaps(got, want):
    """Each gradient's max |got - want| over its own max |want|."""
    return [float(np.abs(np.asarray(g, np.float64) - np.asarray(w)).max()
                  / np.abs(np.asarray(w)).max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_plain_backward_matches_jax_vjp(J, D, mask):
    """Against jax.vjp of the reference's attention_naive and of its
    attention_ref (finite here: no window empties a row's first chunk,
    ROADMAP C5), every gradient within F32_REDUCTION.w_rel of its max."""
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    got = [g.numpy() for g in _port_grads(args, **opts)]
    for fn in (J.ref.attention_naive, J.ref.attention_ref):
        want = _jax_grads(J, fn, args, **opts)
        assert all(np.isfinite(w).all() for w in want)
        assert [g.shape for g in got] == [w.shape for w in want]
        gaps = _gaps(got, want)
        assert max(gaps) <= F32_REDUCTION.w_rel, (fn.__name__, gaps)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_plain_backward_matches_f64_autograd(D, mask):
    _, opts, group, extra = mask
    args = _inputs(D, group, extra)
    gaps = _gaps([g.numpy() for g in _port_grads(args, **opts)],
                 [g.numpy() for g in _f64_grads(args, **opts)])
    assert max(gaps) <= F64_TOL, gaps


def _control(name, args, opts):
    """A wrong backward: the cap's derivative dropped, the window dropped
    from the backward's mask (the forward keeps it), or dS rounded to bf16
    before the dQ and dK products."""
    q, k, v, dout = (torch.from_numpy(a) for a in args)
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **opts)
    if name == "softcap_dropped":
        return ref.attention_grads(q, k, v, out, lse, dout,
                                   softcap_grad=False, **opts)
    if name == "window_dropped":
        return ref.attention_grads(q, k, v, out, lse, dout,
                                   **dict(opts, window=0))
    return ref.attention_grads(q, k, v, out, lse, dout, ds_split=1, **opts)


@pytest.mark.parametrize("name", ["softcap_dropped", "window_dropped",
                                  "ds_bf16"])
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_controls_fail_the_f64_bound(D, name):
    _, opts, group, extra = MASKS[2]  # the window + softcap case
    args = _inputs(D, group, extra)
    want = [g.numpy() for g in _f64_grads(args, **opts)]
    assert max(_gaps([g.numpy() for g in _port_grads(args, **opts)],
                     want)) <= F64_TOL
    gaps = _gaps([g.numpy() for g in _control(name, args, opts)], want)
    assert max(gaps) > F64_TOL, (name, gaps)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_lse_leaves_the_output_bitwise_and_is_the_masked_logsumexp(mask):
    _, opts, group, extra = mask
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(64, group, extra))
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dtype) for t in (q, k, v)]
        out, lse = ref.attention_ref(*a, return_lse=True, chunk=32, **opts)
        assert torch.equal(out, ref.attention_ref(*a, chunk=32, **opts))
        assert lse.dtype == torch.float32 and lse.shape == (2, 4, S)
    want = _masked_logsumexp(q, k, **opts)
    _, lse = ref.attention_ref(q, k, v, return_lse=True, chunk=32, **opts)
    assert float((lse.double() - want).abs().max()) <= 1e-5


def _masked_logsumexp(q, k, *, causal=True, window=0, softcap=0.0,
                      q_offset=0):
    """(B, H, Sq) logsumexp of the masked scores, in f64."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    kk = k.double().repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / D ** 0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq)[:, None]
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= qpos - kpos < window
    return torch.logsumexp(s.masked_fill(~mask, -np.inf), dim=-1)


def test_rows_that_see_no_key_give_minus_inf_lse_and_zero_gradients():
    """Queries at positions 25..32 with a window of 10 over 20 keys: the
    rows at 29 and past see no key: lse -inf, output 0, a zero dq, and
    their dout changes no gradient; the live rows' lse is the masked
    logsumexp and their gradients match f64 autograd over them alone."""
    opts = dict(causal=True, window=10, q_offset=25)
    args = _inputs(16, 2, 12, Sq=8)
    q, k, v, dout = (torch.from_numpy(a) for a in args)
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **opts)
    live = 4  # positions 25..28
    assert torch.equal(lse[..., live:],
                       torch.full_like(lse[..., live:], -np.inf))
    assert float((lse[..., :live].double() - _masked_logsumexp(
        q[:, :live], k, **opts)).abs().max()) <= 1e-5
    assert torch.equal(out[:, live:], torch.zeros_like(out[:, live:]))
    dq, dk, dv = ref.attention_grads(q, k, v, out, lse, dout, **opts)
    assert torch.equal(dq[:, live:], torch.zeros_like(dq[:, live:]))
    want = _f64_grads([a[:, :live] if i in (0, 3) else a
                       for i, a in enumerate(args)], **opts)
    assert max(_gaps([dq[:, :live].numpy(), dk.numpy(), dv.numpy()],
                     [w.numpy() for w in want])) <= F64_TOL
    dout2 = dout.clone()
    dout2[:, live:] = 1e3
    again = ref.attention_grads(q, k, v, out, lse, dout2, **opts)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


# ---------------------------------------------------------------------------
# _FlashAttention wired up with plain kernels
# ---------------------------------------------------------------------------
@pytest.fixture
def plain_kernels(monkeypatch):
    """_FlashAttention's two kernel calls replaced by the plain versions,
    each counting its calls; ops.flash_attention routes a CPU call in grad
    mode whose q, k or v requires grad through _FlashAttention, as it
    routes a CUDA call."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, *, return_lse=False, **opts):
        assert return_lse
        calls["fwd"] += 1
        return ref.attention_ref(q, k, v, return_lse=True, **opts)

    def bwd(q, k, v, out, lse, dout, **opts):
        calls["bwd"] += 1
        return ref.attention_grads(q, k, v, out, lse, dout, **opts)

    orig = ops.flash_attention

    def routed(q, k, v, causal=True, window=0, softcap=0.0, q_offset=0,
               force="auto"):
        if force != "ref" and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return ops._FlashAttention.apply(q, k, v, causal, window,
                                             softcap, q_offset)
        return orig(q, k, v, causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset, force=force)

    routed.launches = orig.launches  # _FlashAttention counts on it
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(ops, "flash_attention_bwd", bwd)
    monkeypatch.setattr(ops, "flash_attention", routed)
    return calls


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
def test_function_gradients_match_autograd_and_jax(J, plain_kernels, mask):
    _, opts, group, extra = mask
    args = _inputs(64, group, extra)
    dout = torch.from_numpy(args[3])
    grads = []
    for through in ("function", "autograd"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args[:3]]
        if through == "function":
            out = ops._FlashAttention.apply(*leaves, opts.get("causal"),
                                            opts.get("window", 0),
                                            opts.get("softcap", 0.0),
                                            opts.get("q_offset", 0))
        else:
            out = ref.attention_ref(*leaves, **opts)
        grads.append(torch.autograd.grad(out, leaves, dout))
    assert plain_kernels == {"fwd": 1, "bwd": 1}
    got, auto = grads
    assert max(_gaps([g.numpy() for g in got],
                     [g.numpy() for g in auto])) <= F64_TOL
    want = _jax_grads(J, J.ref.attention_ref, args, **opts)
    assert max(_gaps([g.numpy() for g in got], want)) <= \
        F32_REDUCTION.w_rel


def test_function_gives_none_for_an_input_that_needs_no_grad(plain_kernels):
    args = _inputs(16, 2)
    q, v = (torch.from_numpy(a).requires_grad_() for a in (args[0], args[2]))
    k = torch.from_numpy(args[1])
    out = ops._FlashAttention.apply(q, k, v, True, 40, 50.0, 0)
    out.backward(torch.from_numpy(args[3]))
    assert k.grad is None and q.grad is not None and v.grad is not None
    saved = ref.attention_ref(q.detach(), k, v.detach(), window=40,
                              softcap=50.0, return_lse=True)
    ctx = types.SimpleNamespace(
        saved_tensors=(q.detach(), k, v.detach(), *saved),
        opts=dict(causal=True, window=40, softcap=50.0, q_offset=0),
        needs_input_grad=(True, False, True, False, False, False, False))
    grads = ops._FlashAttention.backward(ctx, torch.from_numpy(args[3]))
    assert len(grads) == 7 and grads[1] is None and grads[3:] == (None,) * 4
    assert torch.equal(grads[0], q.grad) and torch.equal(grads[2], v.grad)


def test_function_gradients_take_each_input_dtype(plain_kernels):
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16)
                     for a in _inputs(64, 2))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = ops._FlashAttention.apply(*leaves, True, 0, 0.0, 0)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out, leaves, dout)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [t.shape for t in leaves]


def test_a_cpu_call_in_grad_mode_stays_on_the_plain_path():
    """Without the patch, a CPU call is the plain version under autograd:
    no launch is counted and no Function is made."""
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(16, 1))
    q.requires_grad_()
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = ops.flash_attention(q, k, v, window=40)
    assert out.grad_fn is not None
    assert "FlashAttention" not in type(out.grad_fn).__name__
    out.backward(dout)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == before


def _model_pair(J, arch):
    """(jax model, numpy tree, port model) of reduced `arch` at chunk 16;
    the hybrid's A_log and dt_bias as Mamba-2 initialises them."""
    jm = J.Model(J.reduced_config(J.get_config(arch), seq_chunk=16),
                 mesh=None, param_dtype=J.jnp.float32)
    tree = J.jax.tree.map(lambda a: np.array(a),
                          jm.init(J.jax.random.PRNGKey(0)))
    lay = tree["layers"].get("ssm")
    if lay is not None:
        rng = np.random.default_rng(0)
        shape = lay["A_log"].shape
        lay["A_log"] = np.log(rng.uniform(1.0, 16.0, shape)).astype(
            np.float32)
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        lay["dt_bias"] = np.log(np.expm1(dt0)).astype(np.float32)
    pm = Model(reduced_config(get_config(arch), seq_chunk=16), device="cpu",
               param_dtype=torch.float32)
    return jm, tree, pm


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b"])
def test_training_through_the_function_matches_jax(J, plain_kernels, arch):
    """Reduced gemma2 (2 layers: a local one, window 8 over 32 tokens, and
    a global one; softcap 50; GQA) and zamba2 (4 layers, 2 sites of the
    shared block) through _FlashAttention: one forward and one backward
    call a layer or site, and the loss and every gradient leaf within
    F32_REDUCTION of jax.value_and_grad of the reference's Model.loss."""
    jm, tree, pm = _model_pair(J, arch)
    batch = J.tokens.synthetic_token_batch(0, 0, 2, 32, pm.cfg.vocab_size)
    (want_loss, _), want = J.jax.value_and_grad(
        lambda p: jm.loss(p, batch), has_aux=True)(
            J.jax.tree.map(J.jnp.asarray, tree))
    want = [np.asarray(g) for g in J.jax.tree.leaves(want)]
    loss, _, grads = port_train.loss_and_grads(
        pm, port_params.from_numpy(tree, device="cpu"),
        {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()})
    sites = 2  # gemma2: its 2 layers; zamba2: (i + 1) % 2 == 0 of 4
    assert plain_kernels == {"fwd": sites, "bwd": sites}
    assert abs(float(loss) - float(want_loss)) <= \
        F32_REDUCTION.obj_rel * float(want_loss)
    got = [g.numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in got] == [w.shape for w in want]
    # the port's padded heads are inert (their wo rows take exactly 0); the
    # reference's wo gradient with those rows masked is the unpadded one's
    assert padded_wo_gradient(pm.cfg, tree, got) == 0.0
    assert max(_gaps(got, unpadded(pm.cfg, tree, want))) <= \
        F32_REDUCTION.w_rel


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b"])
def test_remat_through_the_function_changes_no_bit(plain_kernels, arch):
    """remat='full' relaunches each layer's forward in the backward (two
    forward calls a layer or site) and gives bitwise remat='none''s loss
    and gradients."""
    cfg = reduced_config(get_config(arch))
    batch = TokenPipeline(seed=1, batch=2, seq_len=32,
                          vocab_size=cfg.vocab_size, device="cpu").next()
    runs = []
    for remat in ("none", "full"):
        model = Model(cfg, device="cpu", param_dtype=torch.float32,
                      remat=remat)
        before = dict(plain_kernels)
        loss, _, grads = port_train.loss_and_grads(model, model.init(0),
                                                   batch)
        runs.append((loss, tree_leaves(grads),
                     {n: plain_kernels[n] - before[n] for n in before}))
    assert runs[0][2] == {"fwd": 2, "bwd": 2}
    assert runs[1][2] == {"fwd": 4, "bwd": 2}
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b", "mamba2-130m"])
def test_loss_and_grads_leaves_no_gradient_to_the_cyclic_collector(arch):
    """With the cyclic garbage collector off, the gradients of
    loss_and_grads are freed as soon as the caller drops them: no
    reference cycle holds them (one did, through tree_unflatten's
    recursive closure, and so held a gradient tree a training step until
    the collector ran: 6.8 GB at gemma2-9b's 4-layer cut on the card)."""
    import gc
    import weakref
    cfg = reduced_config(get_config(arch))
    model = Model(cfg, device="cpu", param_dtype=torch.float32)
    batch = TokenPipeline(seed=1, batch=2, seq_len=32,
                          vocab_size=cfg.vocab_size, device="cpu").next()
    params = model.init(0)
    gc.collect()
    gc.disable()
    try:
        _, _, grads = port_train.loss_and_grads(model, params, batch)
        refs = [weakref.ref(g) for g in tree_leaves(grads)]
        del grads
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# The wrapper, the kernel's checks, budget and source
# ---------------------------------------------------------------------------
def test_ops_backward_takes_the_plain_version_on_the_cpu():
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(64, 2))
    opts = dict(window=40, softcap=50.0)
    out, lse = ref.attention_ref(q, k, v, return_lse=True, **opts)
    want = ref.attention_grads(q, k, v, out, lse, dout, **opts)
    before = ops.flash_attention_bwd.launches
    for force in ("auto", "ref"):
        got = ops.flash_attention_bwd(q, k, v, out, lse, dout, force=force,
                                      **opts)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.flash_attention_bwd.launches == before
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention_bwd(q, k, v, out, lse, dout, force="cuda")
    with pytest.raises(ValueError, match="force"):
        ops.flash_attention_bwd(q, k, v, out, lse, dout, force="kernel")


def _bwd_args(dtype=torch.float32, D=64):
    q = torch.zeros(2, 9, 4, D, dtype=dtype)
    k = torch.zeros(2, 11, 2, D, dtype=dtype)
    return dict(q=q, k=k, v=k.clone(), out=torch.zeros_like(q),
                lse=torch.zeros(2, 4, 9), dout=torch.zeros_like(q))


def _bad_bwd_args(case):
    a = _bwd_args()
    if case == "out_shape":
        a["out"] = a["out"][:, :8]
    elif case == "out_dtype":
        a["out"] = a["out"].double()
    elif case == "dout_dtype":
        a["dout"] = a["dout"].to(torch.bfloat16)
    elif case == "lse_shape":
        a["lse"] = a["lse"][..., :8]
    elif case == "lse_dtype":
        a["lse"] = a["lse"].to(torch.bfloat16)
    elif case == "dout_strided":
        a["dout"] = torch.zeros(2, 4, 9, 64).transpose(1, 2)
    elif case == "lse_strided":
        a["lse"] = torch.zeros(2, 9, 4).transpose(1, 2)
    elif case == "head_dim":
        a = _bwd_args(D=32)
    elif case == "window":
        return a, dict(window=-1)
    return a, {}


@pytest.mark.parametrize("case", ["out_shape", "out_dtype", "dout_dtype",
                                  "lse_shape", "lse_dtype", "dout_strided",
                                  "lse_strided", "head_dim", "window"])
def test_check_bwd_args_refuses(case):
    a, opts = _bad_bwd_args(case)
    with pytest.raises(ValueError, match="flash_attention"):
        kernel.check_bwd_args(**a, **opts)


@pytest.mark.parametrize("dtype", kernel.DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", kernel.HEAD_DIMS)
def test_backward_takes_every_head_dim_in_both_dtypes_within_budget(D,
                                                                   dtype):
    """Every head dim in both dtypes passes the checks when its operands
    are 16-byte aligned; q 2 or 4 bytes past alignment is refused (TMA
    reads q, k, v and dout), and ``ops.tma_operand`` hands over an aligned
    copy that the checks take. Each of the two large kernels fits one
    block's shared memory, 96 and 112 in the 128 layout's."""
    a = _bwd_args(dtype, D)
    buf = torch.zeros(a["q"].numel() + 1, dtype=dtype)
    a["q"] = buf[1:].view(a["q"].shape)  # 2 or 4 bytes past alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernel.check_bwd_args(**a, window=4, softcap=50.0, q_offset=7)
    a["q"] = ops.tma_operand(a["q"])
    assert a["q"].data_ptr() % 16 == 0
    kernel.check_bwd_args(**a, window=4, softcap=50.0, q_offset=7)
    need = kernel.bwd_shared_memory_bytes(D, dtype)
    assert 0 < need <= kernel.SHARED_MEMORY_BUDGET
    assert need == kernel.bwd_shared_memory_bytes(kernel.layout_head_dim(D),
                                                  dtype)


def test_backward_shared_memory_at_head_dim_256_is_pinned():
    """At D = 256, bf16: K and V (64 x 256 bf16), a ring of two stages of
    Q and dO (64 x 256 bf16), two buffers of the 64 x 64 f32 values handed
    between the warpgroups, each stage's lse and Delta, barriers and
    alignment. f32: K and V in f32, one staging slot of 16-row f32 Q and
    dO, their three bf16 pieces each, two 64 x 16 buffers, lse and Delta
    and their copy. A 32-row f32 stream would not fit."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert kernel.bwd_block_n(256, bf16) == 64
    assert kernel.bwd_block_n(256, f32) == 16
    assert kernel.bwd_shared_memory_bytes(256, bf16) == 231_488
    assert 231_488 == (2 * 64 * 256 * 2 + 2 * 2 * 64 * 256 * 2
                       + 2 * 4 * 64 * 64 + 4 * 4 * 64 + 64 + 1024)
    assert kernel.bwd_shared_memory_bytes(256, f32) == 222_528
    assert 222_528 == (2 * 64 * 256 * 4 + 2 * 16 * 256 * 4
                       + 2 * 3 * 16 * 256 * 2 + 2 * 4 * 64 * 16
                       + 4 * 4 * 16 + 64 + 1024)
    assert (2 * 64 * 256 * 4 + 2 * 32 * 256 * 4 + 2 * 3 * 32 * 256 * 2
            > kernel.SHARED_MEMORY_BUDGET)
    assert [kernel.bwd_block_n(D, f32) for D in kernel.HEAD_DIMS] == \
        [32, 32, 32, 32, 32, 16]
    assert all(kernel.bwd_block_n(D, bf16) == 64 for D in kernel.HEAD_DIMS)
    assert {kernel.bwd_route(t, 64) for t in kernel.DTYPES} == \
        set(kernel.BWD_ROUTES)


def test_backward_source_mirrors_the_module():
    """The source's tile rules, resident rows and dtype codes are the
    module's, it reads its tiles by TMA and forms its products by wgmma,
    and it has no atomics."""
    text = kernel.BWD_SOURCE.read_text()
    assert "kBN = kF32 ? (L == 256 ? 16 : 32) : 64" in text
    assert f"constexpr int kRows = {kernel.BWD_ROWS};" in text
    assert "kRing = kF32 ? 1 : 2" in text
    assert "kSplitDq = kBN >= 32" in text
    for dtype, name in ((torch.float32, "float"),
                        (torch.bfloat16, "__nv_bfloat16")):
        code = kernel.BWD_DTYPE_CODES[dtype]
        assert re.search(rf"if \(dtype == {code}\)\s*return dispatch_d<"
                         rf"{re.escape(name)}>", text), name
    for needle in ("tma_load(", "wgmma_ss64(", "wgmma_rs<", "mbar_wait("):
        assert needle in text, needle
    # bitwise across launches: no atomic read-modify-write anywhere
    for src in (text, (kernel.BWD_SOURCE.parent / "sm90.cuh").read_text()):
        assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", src)


@pytest.mark.gpu
def test_backward_kernel_matches_plain_on_the_card():
    """The kernel against the plain backward on the card, on inputs made
    by the card's own forward kernel (out and lse): f32 within 1e-5 of
    each gradient's max, bf16 within half a bf16 ulp of the f32 gradient +
    2^-18 of its max; two launches bitwise, each counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m gpu tests/test_torch_flash_backward.py)")
    cases = [((2, 4, 2, 200, 64), dict(causal=True)),
             ((2, 4, 2, 200, 64), dict(causal=False)),
             ((1, 4, 4, 130, 16), dict(causal=True, window=40)),
             ((1, 8, 2, 256, 128), dict(causal=True, softcap=30.0)),
             ((1, 16, 8, 300, 256), dict(causal=True, window=100,
                                         softcap=50.0)),
             ((2, 4, 4, 200, 112), dict(causal=True)),
             ((1, 4, 4, 170, 96), dict(causal=True, window=50))]
    g = torch.Generator(device="cuda").manual_seed(0)
    for (B, H, KV, S_, D), opts in cases:
        q = torch.randn(B, S_, H, D, generator=g, device="cuda")
        k = torch.randn(B, S_, KV, D, generator=g, device="cuda")
        v = torch.randn(B, S_, KV, D, generator=g, device="cuda")
        dout = torch.randn(B, S_, H, D, generator=g, device="cuda")
        for dtype in kernel.DTYPES:
            a = [t.to(dtype) for t in (q, k, v, dout)]
            out, lse = kernel.flash_attention_cuda(*a[:3], return_lse=True,
                                                   **opts)
            before = ops.flash_attention_bwd.launches
            got = ops.flash_attention_bwd(*a[:3], out, lse, a[3], **opts)
            again = ops.flash_attention_bwd(*a[:3], out, lse, a[3], **opts)
            want = ref.attention_grads(*[t.float() for t in a[:3]],
                                       out.float(), lse, a[3].float(),
                                       **opts)
            torch.cuda.synchronize()
            assert ops.flash_attention_bwd.launches == before + 2
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            for x, w in zip(got, want):
                assert x.dtype == dtype
                scale = float(w.abs().max())
                if dtype == torch.float32:
                    assert float((x - w).abs().max()) <= F64_TOL * scale
                else:
                    ex = half_ulp_excess(w, scale, kernel=x)["kernel"]
                    assert ex <= F32_NOISE, (B, H, KV, S_, D, opts, ex)
