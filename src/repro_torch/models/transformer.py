"""Model assembly for the dense transformer, MoE, SSM and hybrid families:
templates, the prefill forward (cache construction) and decode (cache
consumption).

Counterpart of ``repro.models.transformer``. The reference scans over a
stacked ``(L, ...)`` parameter tree; here a Python loop over layers indexes
the stacked parameters as views. gemma2's local/global alternation is a
per-layer window: even layers see ``cfg.sliding_window`` keys, odd layers
all of them. An SSM layer is a pre-normed Mamba-2 block with a residual.
The hybrid family (zamba2) is the SSM stack with one shared attention + MLP
block (``params['shared']``, no post-norms) applied after SSM layer i
wherever (i + 1) % ``cfg.attn_every`` == 0; its window is
``cfg.sliding_window`` under ``long_context`` only (or, in decode, a ring
cache of the window's slots), and decode keeps one KV cache per
application site. The ``vlm`` and ``audio`` families run the dense
stack, as in the reference; a vlm's frontend is a stub, as there:
``frontend_embeds`` (B, F, d), precomputed patch embeddings, are put ahead
of the token embeddings, so positions run over F + S, and the loss skips
their F positions. The MoE family (arctic-480b, kimi-k2) runs the dense
stack with ``models.moe``'s block in place of each layer's MLP; each
layer's auxiliary load-balancing loss is summed over the layers, as the
reference's scan carries it, and ``loss_fn`` adds it. The training loss
(``loss_fn``) runs the same forward; ``remat`` checkpoints each layer
(``torch.utils.checkpoint``), trading memory for a second forward in the
backward, or under "collectives" each layer's local work between its
all-reduces (``_remat``).

Over a mesh of ranks (``tp``, a
``distributed.tensor_parallel.TensorParallel``) the dense and MoE
families run tensor-parallel: every entry point takes the rank's shards
of the parameters, and each block all-reduces its attention and MLP
outputs over the 'model' axis ('attn_out', 'mlp_out', the names the
reference's "collectives" policy saves). An MoE block sums its own output
over both axes (``moe.moe_forward`` over a mesh: the route over the
global batch, the experts in the 'gather' or 'token_tp' layout, which
`pspec_fn` names). Decode switches between the 'heads' and the 'seq'
attention as the reference's ``_decode_attn`` does.

The SSM and hybrid families run the reference's three layouts over a mesh
(``sharding_rules.rules_for`` splits the SSM heads over 'model' when they
divide it; ``batch_axes`` lays the SSM family's rows over 'model' too when
the batch divides both axes, which `pspec_fn` says):

* A, the heads split, the rows over 'data': each SSM layer runs
  tensor-parallel on the rank's heads (``ssm.ssm_forward`` with `tp`),
  the hybrid's shared block as a dense block;
* B, the heads split, the rows over 'data' and 'model': each layer's
  leaves split over 'model' are gathered whole (``ssm.gather_heads``,
  'ssm_weights'; their gradients reduce-scattered back) and the layer
  runs on the rank's own rows as on one device; the vocabulary leaves
  are gathered so too ('vocab_weights'), since the split embedding and
  cross entropy assume every model rank holds the same rows;
* C, the heads replicated (the model axis does not divide them): as B,
  with only the vocabulary gathered when the rows lie over 'model', and
  with the vocabulary tensor-parallel when they do not.

Decode follows the cache's layout (``Model.cache_pspecs``: the state's
rows over the data axes, its heads as the rules say), so it runs A, or C
with the vocabulary tensor-parallel.

On a mesh with a 'pod' axis (the reference's multi-pod layout) every
family runs as above with 'pod' joining 'data' for the batch: the rows
over ('pod', 'data'), and in B over ('pod', 'data', 'model'). A hybrid
grid whose model axis does not divide the kv heads trains with the kv
heads replicated (``TensorParallel.kv_index``, ``kv_weight``), as the
dense family does; it does not serve, since its cache's spec splits the
kv heads over 'model' and cannot be placed there (nor can the
reference's: ``_serving_on_mesh``).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, mlp, moe, ssm
from repro_torch.models.layers import (cross_entropy, embed_tokens, rms_norm,
                                       unembed)
from repro_torch.models.params import ParamSpec, tree_map_specs


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------
def _norm(d):
    return ParamSpec((d,), ("embed",), init="zeros")


def layer_template(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": _norm(d), "ssm": ssm.ssm_template(cfg)}
    t = {"ln1": _norm(d), "attn": attention.attn_template(cfg),
         "ln2": _norm(d)}
    if cfg.num_experts:
        t["moe"] = moe.moe_template(cfg)
    else:
        t["mlp"] = mlp.mlp_template(d, cfg.d_ff)
    if cfg.local_global:  # gemma2 post-norms
        t["ln1post"] = _norm(d)
        t["ln2post"] = _norm(d)
    return t


def model_template(cfg: ArchConfig) -> dict:
    d, Vp, L = cfg.d_model, cfg.padded_vocab, cfg.num_layers
    t = {"embed": ParamSpec((Vp, d), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        t["unembed"] = ParamSpec((d, Vp), ("embed", "vocab"))
    t["final_norm"] = _norm(d)
    t["layers"] = tree_map_specs(
        lambda s: ParamSpec((L,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale), layer_template(cfg))
    if cfg.family == "hybrid":
        t["shared"] = shared_block_template(cfg)
    return t


def shared_block_template(cfg: ArchConfig) -> dict:
    """The hybrid family's one attention + MLP block, shared by every site."""
    d = cfg.d_model
    return {"ln1": _norm(d), "attn": attention.attn_template(cfg),
            "ln2": _norm(d), "mlp": mlp.mlp_template(d, cfg.d_ff)}


def n_attn_sites(cfg: ArchConfig) -> int:
    return cfg.num_layers // cfg.attn_every if cfg.attn_every else 0


def is_attn_site(cfg: ArchConfig, i: int) -> bool:
    """Whether the hybrid family's shared block follows SSM layer `i`."""
    return (i + 1) % cfg.attn_every == 0


def layer_params(layers: dict, i: int) -> dict:
    """Layer `i`'s parameters: views into the stacked (L, ...) tensors."""
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


def layer_window(cfg: ArchConfig, i: int) -> int:
    """gemma2: even layers local (sliding window), odd global."""
    return cfg.sliding_window if (cfg.local_global and i % 2 == 0) else 0


def _embed(params, tokens, cfg: ArchConfig, tp=None):
    h = embed_tokens(params["embed"], tokens, tp)
    if cfg.local_global:  # gemma scales embeddings, by sqrt(d) in h's dtype
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        h = h * scale.to(device=h.device, dtype=h.dtype)
    return h


def _logits(params, h, cfg: ArchConfig, tp=None, whole: bool = False):
    """The final norm and the unembedding: f32 logits. With `tp` they are
    the rank's vocabulary columns, or with `whole` all of them (gathered
    over the axis; not differentiated: the serving paths)."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    wout = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = unembed(h, wout, cfg.final_logit_softcap, tp)
    if tp is not None and whole:
        logits = tp.gather(logits, logits.dim() - 1, "logits")
    return logits


def _reduce(x, tp, tag):
    """A tensor-parallel block output all-reduced over the axis (itself on
    one device)."""
    return x if tp is None else tp.reduce(x, tag)


def _ffn(lp, h, cfg: ArchConfig, tp, pspec_fn=None, pieces=None):
    """The MLP (or MoE) on h's norm: its output and the MoE block's
    auxiliary loss, or None for an MLP. With `tp` the MLP's output is the
    rank's partial sum (``_ffn_out`` all-reduces it) and the MoE's is
    whole (summed inside ``moe.moe_forward``, whose local work `pieces`
    wraps)."""
    x = rms_norm(h, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        return moe.moe_forward(lp["moe"], x, cfg, pspec_fn=pspec_fn, tp=tp,
                               pieces=pieces)
    return mlp.mlp_forward(lp["mlp"], x, tp), None


def _ffn_out(lp, m, tp):
    """The MLP's partial output all-reduced over the axis ('mlp_out'); an
    MoE block's output as it is (already whole)."""
    return m if "moe" in lp else _reduce(m, tp, "mlp_out")


def _mlp_in(lp, h, a, cfg: ArchConfig, tp, pspec_fn=None, pieces=None):
    """The block's work between its two all-reduces: the attention output
    `a` (post-normed) added to h, then the MLP's (or MoE's) output.
    Returns (h + a, the output, aux)."""
    if "ln1post" in lp:
        a = rms_norm(a, lp["ln1post"], cfg.norm_eps)
    h = h + a
    return (h,) + _ffn(lp, h, cfg, tp, pspec_fn, pieces)


def _mlp_out(lp, h, m, cfg: ArchConfig):
    if "ln2post" in lp:
        m = rms_norm(m, lp["ln2post"], cfg.norm_eps)
    return h + m


def _mlp_half(lp, h, cfg: ArchConfig, tp=None, pspec_fn=None):
    """The MLP (or MoE) half of a block: (h + its output, the MoE block's
    auxiliary loss, or None for an MLP)."""
    m, aux = _ffn(lp, h, cfg, tp, pspec_fn)
    return _mlp_out(lp, h, _ffn_out(lp, m, tp), cfg), aux


def _attn_in(lp, h, cfg: ArchConfig, positions, window: int, force: str,
             tp):
    """The block's work up to its first all-reduce: the attention's
    (partial) output and its (k, v)."""
    return attention.attn_forward(lp["attn"],
                                  rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
                                  positions, window=window, force=force,
                                  tp=tp)


def _attn_block(lp, h, cfg: ArchConfig, positions, window: int, force: str,
                tp=None, pieces=None, pspec_fn=None):
    """One attention + MLP block: (h out, (k, v), aux). `pieces` wraps
    the block's local work between its all-reduces (``_attn_in`` and
    ``_mlp_in``; over a mesh an MoE block's collectives lie inside it, so
    its own local pieces are wrapped instead): the "collectives" remat
    checkpoints them, so the backward recomputes local work and never a
    collective."""
    attn_in = _attn_in if pieces is None else pieces(_attn_in)
    a, kv = attn_in(lp, h, cfg, positions, window, force, tp)
    a = _reduce(a, tp, "attn_out")
    if pieces is not None and "moe" in lp and tp is not None:
        h, m, aux = _mlp_in(lp, h, a, cfg, tp, pspec_fn, pieces)
    else:
        mlp_in = _mlp_in if pieces is None else pieces(_mlp_in)
        h, m, aux = mlp_in(lp, h, a, cfg, tp, pspec_fn)
    return _mlp_out(lp, h, _ffn_out(lp, m, tp), cfg), kv, aux


def _ssm_block(lp, h, cfg: ArchConfig, force: str, tp=None, pieces=None):
    """One SSM layer: h + the Mamba-2 block on h's norm. With `tp` (the
    heads split, the rows over 'data') the block runs on the rank's heads
    and `pieces` wraps its local work before the first collective
    (``ssm.ssm_forward``)."""
    return h + ssm.ssm_forward(lp["ssm"], rms_norm(h, lp["ln"], cfg.norm_eps),
                               cfg, chunk=min(cfg.ssm_chunk, h.shape[1]),
                               force=force, tp=tp, pieces=pieces)


REMATS = ("none", "full", "dots", "collectives")


def _checkpointed(fn):
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _remat(fn, remat: str):
    """`fn`, a block, run as the reference's ``_maybe_remat`` asks.
    "none": as it is. "full": checkpointed (``torch.utils.checkpoint``,
    non-reentrant): its activations are dropped after the forward and
    recomputed in the backward. "dots": the reference's XLA policy saves
    matmul outputs and recomputes the rest; eager PyTorch has no such
    policy, so it checkpoints the whole block as "full" does.
    "collectives": the reference saves the tensor-parallel all-reduce
    outputs ('attn_out', 'mlp_out') and recomputes the rest; here an
    attention block checkpoints its local work between the all-reduces
    (``_attn_block``'s `pieces`), an SSM layer over a mesh its local work
    before the first collective (``_ssm_layer``), so the recompute never
    runs a collective, and a block with no collectives (an SSM layer on
    one device) is checkpointed whole. Every policy gives the same
    gradients, bit for bit."""
    if remat == "none":
        return fn
    if remat in REMATS:
        return _checkpointed(fn)
    raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")


def _serving_on_mesh(cfg: ArchConfig, tp):
    """Refuse the one layout not run over a mesh: serving a hybrid on a
    grid whose model axis does not divide the kv heads. Its cache's spec
    (``Model.cache_pspecs``, the reference's ``cache_pspecs``) splits the
    kv heads over 'model', and the reference cannot place that cache
    either: ``jax.device_put`` of its 'ak' raises ValueError (dimension 3
    not divisible). Training there runs, the kv heads replicated."""
    if (tp is not None and cfg.family == "hybrid"
            and cfg.num_kv_heads % tp.size):
        raise NotImplementedError(
            f"{cfg.name}: a serving cache of {cfg.num_kv_heads} kv heads "
            f"over a model axis of {tp.size} ranks: its spec splits the kv "
            "heads over 'model', which the reference cannot place either "
            "(its device_put of 'ak' raises: dimension 3 not divisible)")


def _rows_over_model(cfg: ArchConfig, tp, pspec_fn) -> bool:
    """Whether the rank's rows lie over 'model' too (the SSM family's
    layouts B and C): what `pspec_fn` gives the batch."""
    return (tp is not None and cfg.family == "ssm"
            and tp.rows_over_model(pspec_fn))


def _whole_vocab(params, tp):
    """`params` with the vocabulary leaves (split over 'model') gathered
    whole, their gradients reduce-scattered back ('vocab_weights')."""
    out = dict(params, embed=tp.gather_model(params["embed"], 0,
                                             "vocab_weights"))
    if "unembed" in params:
        out["unembed"] = tp.gather_model(params["unembed"], 1,
                                         "vocab_weights")
    return out


def _ssm_layer(cfg: ArchConfig, force: str, tp, remat: str, rows: bool):
    """fn(lp, h) -> h: one SSM layer as the layout runs it (see the module
    docstring), under `remat`: "full" and "dots" checkpoint the whole
    layer, its collectives too; "collectives" checkpoints the local work
    between them."""
    pieces = _checkpointed if remat == "collectives" else None
    if tp is not None and tp.ssm_heads and not rows:  # A
        def layer(lp, x):
            return _ssm_block(lp, x, cfg, force, tp, pieces)
    elif tp is not None and tp.ssm_heads:  # B
        def local(lp, x):
            return _ssm_block(lp, x, cfg, force)

        body = local if pieces is None else pieces(local)

        def layer(lp, x):
            return body(dict(lp, ssm=ssm.gather_heads(lp["ssm"], cfg, tp)),
                        x)
    else:  # one device, or the heads replicated (C): no collective
        return _remat(lambda lp, x: _ssm_block(lp, x, cfg, force), remat)
    return layer if remat in ("none", "collectives") else _remat(layer,
                                                                 remat)


# ---------------------------------------------------------------------------
# Train / prefill forward
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ArchConfig, **opts):
    """tokens (B,S) -> (logits (B,S,Vp) f32, cache or None):
    ``forward_with_aux`` without the auxiliary loss."""
    logits, cache, _ = forward_with_aux(params, tokens, cfg, **opts)
    return logits, cache


def forward_with_aux(params, tokens, cfg: ArchConfig, *,
                     frontend_embeds=None, collect_cache: bool = False,
                     last_only: bool = False, force: str = "auto",
                     long_context: bool = False, remat: str = "none",
                     tp=None, pspec_fn=None):
    """tokens (B,S) -> (logits (B,S,Vp) f32, cache or None, aux f32).

    `frontend_embeds` (B,F,d), if given, are cast to the activations'
    dtype and put ahead of the token embeddings: the sequence is then F + S
    positions long, and so are the logits and the cache (S below reads F +
    S). With `collect_cache`, cache is {'k', 'v': (L,B,S,KV,hd)} in the
    activations' dtype, filled layer by layer; the SSM and hybrid families
    build no cache here (None), as in the reference. With `last_only`,
    logits are computed for the last position only: (B,1,Vp). `force` goes
    to the layer's kernel wrapper (``kernels.ops.flash_attention`` or
    ``kernels.ops.ssd_scan``). `long_context` gives the hybrid family's
    shared attention its sliding window. `remat` (``REMATS``) checkpoints
    each layer and each hybrid site (``_remat``); it changes what the
    backward keeps and recomputes, not a value. `aux` is the MoE layers'
    auxiliary losses summed in layer order (0 for the other families).

    With `tp` (a ``distributed.tensor_parallel.TensorParallel``) `params`
    are the rank's shards: the layers run tensor-parallel over the 'model'
    axis, the logits are the rank's vocabulary columns (all of them with
    `last_only`, the serving path), and the cache holds the rank's kv
    heads (all of them when the rules replicate them). `pspec_fn`
    (``sharding_rules.activation_pspec_fn``, the reference's argument)
    names the MoE layout (``moe.moe_forward``) and where the batch's rows
    lie: over 'model' too (the SSM family's layouts B and C), the
    vocabulary leaves are gathered and the logits are whole (see the
    module docstring).
    """
    rows = _rows_over_model(cfg, tp, pspec_fn)
    vtp = tp
    if rows:
        params, vtp = _whole_vocab(params, tp), None
    h = _embed(params, tokens, cfg, vtp)
    if frontend_embeds is not None:
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device).expand(B, S)

    def block(lp, x, window, pieces=None):
        return _attn_block(lp, x, cfg, positions, window, force, tp, pieces,
                           pspec_fn)

    if remat == "collectives":
        def attn_block(lp, x, window):
            return block(lp, x, window, _checkpointed)
    else:
        attn_block = _remat(block, remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family in ("ssm", "hybrid"):
        window = cfg.sliding_window if long_context else 0
        ssm_layer = _ssm_layer(cfg, force, tp, remat, rows)
        for i in range(cfg.num_layers):
            h = ssm_layer(layer_params(params["layers"], i), h)
            if cfg.family == "hybrid" and is_attn_site(cfg, i):
                h, _, _ = attn_block(params["shared"], h, window)
        if last_only:
            h = h[:, -1:]
        return _logits(params, h, cfg, vtp, whole=last_only), None, aux
    L = cfg.num_layers
    cache = None
    for i in range(L):
        h, (k, v), layer_aux = attn_block(layer_params(params["layers"], i),
                                          h, layer_window(cfg, i))
        if layer_aux is not None:
            aux = aux + layer_aux
        if collect_cache:
            if cache is None:
                cache = {n: torch.empty((L,) + t.shape, dtype=h.dtype,
                                        device=h.device)
                         for n, t in (("k", k), ("v", v))}
            cache["k"][i].copy_(k)
            cache["v"][i].copy_(v)
    if last_only:
        h = h[:, -1:]
    return _logits(params, h, cfg, tp, whole=last_only), cache, aux


def loss_fn(params, batch, cfg: ArchConfig, *, remat: str = "none",
            aux_weight: float = 0.01, force: str = "auto", tp=None,
            pspec_fn=None):
    """The training loss: `forward_with_aux` on batch['tokens'] (B,S),
    then the mean cross entropy of its logits against batch['targets']
    (B,S) over the true vocabulary (the padded entries masked), plus
    `aux_weight` x the auxiliary loss (the MoE layers' load-balancing
    losses summed; 0 for the other families). Returns (loss, {'ce',
    'aux'}), f32 scalars. `remat` and `force` go to the forward. With
    batch['frontend_embeds'] (B,F,d) (the vlm family) the forward runs
    over F + S positions and the first F positions' logits, the
    frontend's, carry no loss. With `tp` the batch is the rank's and so
    is the loss (its mean over the rank's tokens, the same on every rank
    of the 'model' axis unless the rows lie over it too, as `pspec_fn`
    may say for the SSM family): the cross entropy runs over the
    vocabulary split across the axis (whole when the rows lie over it),
    and an MoE layer's auxiliary loss is the global batch's (every rank's
    the same)."""
    logits, _, aux = forward_with_aux(
        params, batch["tokens"], cfg,
        frontend_embeds=batch.get("frontend_embeds"), remat=remat,
        force=force, tp=tp, pspec_fn=pspec_fn)
    targets = batch["targets"]
    F = logits.shape[1] - targets.shape[1]
    if F > 0:  # frontend positions carry no loss
        logits = logits[:, F:]
    vtp = None if _rows_over_model(cfg, tp, pspec_fn) else tp
    ce = cross_entropy(logits, targets, cfg.vocab_size, vtp)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
DECODE_MODES = ("heads", "seq")


def decode_step(params, cache, tokens, pos, cfg: ArchConfig, *,
                long_context: bool = False, tp=None,
                decode_mode: str = "heads", pspec_fn=None):
    """tokens (B,1), pos (B,) -> (logits (B,Vp), cache).

    cache: {'k': (L,B,S,KV,hd), 'v': (L,B,S,KV,hd)}, updated in place at
    position ``pos[0] % S`` of every layer and returned; for the SSM family
    {'state': (L,B,nh,hd,N), 'conv': (L,B,k-1,C)}, updated in place (`pos`
    is not read: the state holds the position); for the hybrid family the
    SSM cache and {'ak', 'av': (sites,B,S,KV,hd)}, site s's keys and values
    written in place at ``pos[0] % S``. `long_context` gives the hybrid
    family's shared attention its sliding window, as the reference's flag
    does; a ring cache of the window's slots (``Model.cache_template`` past
    2 x the window) holds the last `window` positions only, so it windows
    the attention whatever the flag. The attention mask is built once a
    step (``attention.decode_mask``), not once a layer. An MoE layer runs
    its block on the (B,1,d) token batch, over every expert's capacity
    buffer, and its auxiliary loss is dropped, as in the reference.

    With `tp` `params` and the cache are the rank's shards and the logits
    are all of the vocabulary (gathered); `decode_mode` is the reference's
    switch (``_decode_attn``): 'heads', the cache holding the rank's kv
    heads, or 'seq', the cache holding the rank's chunk of the sequence,
    every kv head (``attention.decode_attn_seq``). An MoE layer routes the
    global batch's B tokens, in the layout `pspec_fn` names. The SSM and
    hybrid families follow the cache's layout: its rows over the data
    axes, the state's heads as the rules say (split:
    ``ssm.ssm_decode_step`` on the rank's heads), the hybrid's kv heads
    split ('heads' decode; a grid that does not divide them is refused,
    ``_serving_on_mesh``).
    """
    _serving_on_mesh(cfg, tp)
    if decode_mode not in DECODE_MODES and cfg.num_kv_heads:
        raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got "
                         f"{decode_mode!r}")
    h = _embed(params, tokens, cfg, tp)
    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "hybrid":
            mask = attention.decode_mask(
                pos, cache["ak"].shape[2],
                cfg.sliding_window if long_context else 0)
        site = 0
        stp = tp if tp is not None and tp.ssm_heads else None
        for i in range(cfg.num_layers):
            lp = layer_params(params["layers"], i)
            y, _ = ssm.ssm_decode_step(
                lp["ssm"], rms_norm(h, lp["ln"], cfg.norm_eps), cfg,
                {"state": cache["state"][i], "conv": cache["conv"][i]},
                tp=stp)
            h = h + y
            if cfg.family == "hybrid" and is_attn_site(cfg, i):
                sp = params["shared"]
                a, _ = attention.decode_attn_heads(
                    sp["attn"], rms_norm(h, sp["ln1"], cfg.norm_eps), cfg,
                    cache["ak"][site], cache["av"][site], pos, mask=mask,
                    tp=tp)
                h, _ = _mlp_half(sp, h + _reduce(a, tp, "attn_out"), cfg, tp)
                site += 1
        return _logits(params, h, cfg, tp, whole=True)[:, 0], cache
    seq = tp is not None and decode_mode == "seq"
    S = cache["k"].shape[2]
    masks = {} if seq else {
        w: attention.decode_mask(pos, S, w)
        for w in {layer_window(cfg, i) for i in range(cfg.num_layers)}}
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        a, _ = _decode_attn(lp["attn"], rms_norm(h, lp["ln1"], cfg.norm_eps),
                            cfg, cache["k"][i], cache["v"][i], pos, tp,
                            decode_mode, layer_window(cfg, i), masks)
        a = _reduce(a, tp, "attn_out")
        if "ln1post" in lp:
            a = rms_norm(a, lp["ln1post"], cfg.norm_eps)
        h, _ = _mlp_half(lp, h + a, cfg, tp, pspec_fn)
    return _logits(params, h, cfg, tp, whole=True)[:, 0], cache


def _decode_attn(p, x, cfg, k_cache, v_cache, pos, tp, mode, window, masks):
    """The reference's mode switch: the sequence-split flash-decode over
    a mesh in 'seq' mode, else the 'heads' decode (the rank's partial
    output with `tp`)."""
    if mode == "seq" and tp is not None:
        return attention.decode_attn_seq(p, x, cfg, k_cache, v_cache, pos,
                                         tp, window=window)
    return attention.decode_attn_heads(p, x, cfg, k_cache, v_cache, pos,
                                       mask=masks[window], tp=tp)
