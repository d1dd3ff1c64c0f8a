"""Model facade: config, template, device and the training and serving
entry points, plus ``input_specs`` (every input of a cell, on the meta
device).

Counterpart of ``repro.models.model.Model``. Parameters are a nested dict
of tensors passed to each entry point, as in the reference; the module
holds the configuration, the template, the device, the parameter dtype and
the rematerialisation policy. It runs on the CUDA device unless the caller
passes ``device="cpu"``.

A model may lie over a mesh (``mesh``): a mapping of axis sizes such as
``{"data": 16, "model": 16}`` gives the layouts as data (``pspecs``,
``cache_pspecs``, as the reference's); a ``core.distributed.Mesh`` of
ranks also runs the entry points there, tensor-parallel over its 'model'
axis (``distributed.tensor_parallel``): each rank passes its shards of the
parameters (``tensor_parallel.shard_params`` of the whole tree by
``pspecs``) and of the cache (``cache_template``), and its rows of the
batch. Every family runs so: the MoE family's experts in the layout of
`rules_overrides` ('gather' by default, or 'token_tp'), the SSM and hybrid
families' heads split over 'model' or replicated as the rules say, the
SSM family's rows over 'model' too where the step's layout puts them
there (``models.transformer``). On a mesh with a 'pod' axis (the
reference's multi-pod layout, ``core.distributed.Mesh(pods=)``) 'pod'
joins 'data' for the batch and the cache's rows. The one layout refused
is a hybrid's serving cache on a grid whose model axis does not divide
its kv heads, which the reference cannot place either
(``transformer._serving_on_mesh``).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding_rules import (PartitionSpec as P,
                                                    axis_sizes, decode_mode,
                                                    rules_for, split_size)
from repro_torch.distributed.tensor_parallel import TensorParallel
from repro_torch.models import attention, ssm, transformer
from repro_torch.models.params import (count_params, init_params,
                                       param_pspecs, tree_map_specs)
from repro_torch.platform import DeviceLike, resolve_device


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 param_dtype=torch.bfloat16, remat: str = "none", mesh=None,
                 rules_overrides: Optional[dict] = None):
        """`remat` is ``loss``'s layer checkpointing
        (``transformer.REMATS``). The reference defaults to "dots", an XLA
        policy; eager PyTorch has none ("dots" checkpoints whole blocks, as
        "full"), and the gradients are the same bits either way, so the
        default here is "none". `mesh` and `rules_overrides` (a
        ``sharding_rules.MOE_LAYOUTS`` entry) are the reference's: the
        layout of the parameters and caches over a mesh (see the module
        docstring)."""
        super().__init__()
        if remat not in transformer.REMATS:
            raise ValueError(f"remat must be one of {transformer.REMATS}, "
                             f"got {remat!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.param_dtype = param_dtype
        self.remat = remat
        self.mesh = mesh
        self.rules_overrides = rules_overrides
        self.template = transformer.model_template(cfg)
        # the ranks' tensor parallelism, over a mesh of ranks only
        self.tp = None
        if mesh is not None and not isinstance(mesh, Mapping):
            self.tp = TensorParallel(mesh, cfg, self.rules())

    # -- parameters ------------------------------------------------------
    def init(self, seed: int, dtype=None):
        """Weights drawn on the model's device from a generator seeded by
        `seed`, with the padded heads' wo rows zeroed (arctic-480b's 56 q
        heads padded to 64, for one). An expert leaf is drawn one (layer,
        expert) slice at a time (``params._init_one``)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._fixup(init_params(self.template, gen,
                                       dtype or self.param_dtype))

    def _fixup(self, params):
        """Zero the padded q-head wo rows (exact head padding): the stacked
        layers' attention, or the hybrid family's shared block's."""
        cfg = self.cfg
        if cfg.family == "ssm" or attention.padded_heads(cfg) == cfg.num_heads:
            return params
        if cfg.family == "hybrid":
            shared = params["shared"]
            return dict(params, shared=dict(
                shared, attn=attention.zero_padded_wo(cfg, shared["attn"])))
        layers = dict(params["layers"])
        layers["attn"] = attention.zero_padded_wo(cfg, layers["attn"])
        return dict(params, layers=layers)

    def param_count(self) -> int:
        return count_params(self.template)

    def abstract(self, dtype=None):
        """The parameters as tensors on the meta device: their shapes and
        dtype, nothing allocated (the reference's ``abstract``)."""
        return tree_map_specs(
            lambda s: torch.empty(s.shape, dtype=dtype or self.param_dtype,
                                  device="meta"), self.template)

    # -- layouts over the mesh -------------------------------------------
    def rules(self) -> dict:
        return rules_for(self.cfg, self._mesh(), self.rules_overrides)

    def _mesh(self):
        if self.mesh is None:
            raise ValueError(f"{self.cfg.name}: a layout needs a mesh")
        return self.mesh

    def pspecs(self):
        """The parameters' partition specs on the mesh (a tree like the
        parameters)."""
        return param_pspecs(self.template, self.rules(), self._mesh())

    def cache_pspecs(self, shape: Optional[ShapeConfig] = None):
        """Partition specs matching ``cache_template``, the reference's:
        the batch over the data axes (unsplit when `shape`'s batch does not
        divide them), the kv heads over 'model' in 'heads' decode, the
        sequence in 'seq' decode; the SSM state's heads by the rules."""
        cfg, mesh = self.cfg, self.mesh
        sizes = axis_sizes(mesh) if mesh is not None else {}
        mode = decode_mode(cfg, mesh) if mesh is not None else "heads"
        data = ("pod", "data") if "pod" in sizes else ("data",)
        if shape is not None and mesh is not None:
            n = 1
            for a in data:
                n *= sizes[a]
            if shape.global_batch % n:
                data = ()
        b = data if len(data) > 1 else (data[0] if data else None)
        if cfg.family in ("ssm", "hybrid"):
            hax = self.rules()["ssm_heads"]
            out = {"state": P(None, b, hax, None, None),
                   "conv": P(None, b, None, None)}
            if cfg.family == "hybrid":
                out["ak"] = out["av"] = P(None, b, None, "model", None)
            return out
        if mode == "heads":
            return {"k": P(None, b, None, "model", None),
                    "v": P(None, b, None, "model", None)}
        return {"k": P(None, b, "model", None, None),
                "v": P(None, b, "model", None, None)}

    # -- entry points ----------------------------------------------------
    def loss(self, params, batch, force: str = "auto", pspec_fn=None):
        """batch {'tokens', 'targets': (B,S)} -> (loss, {'ce', 'aux'}), f32
        scalars that autograd differentiates (``transformer.loss_fn``, with
        this model's `remat`). On the card every family trains through the
        kernels: the SSD scan's gradient is its backward kernel
        (``ops.ssd_scan_bwd``) and flash attention's is its own
        (``ops.flash_attention_bwd``), so the dense, SSM and hybrid
        families all run their backward passes there. For the MoE family
        'aux' is its layers' load-balancing losses summed, and the loss
        adds 0.01 x it, as the reference's does. `pspec_fn`
        (``sharding_rules.activation_pspec_fn``) is the reference's
        argument: over a mesh it names the MoE layout, which must be that
        of the rank's shards (``moe.moe_forward``)."""
        return transformer.loss_fn(params, batch, self.cfg,
                                   remat=self.remat, force=force, tp=self.tp,
                                   pspec_fn=pspec_fn)

    def prefill(self, params, batch, force: str = "auto", pspec_fn=None):
        """batch {'tokens': (B,S)} -> (last-position logits (B,Vp) f32,
        cache {'k', 'v': (L,B,S,KV,hd)} (the dense and MoE families), or
        None for the SSM and hybrid families, whose prefill builds no
        decode state, as in the reference). With batch['frontend_embeds'] (B,F,d) (the vlm
        family) they go ahead of the tokens: the cache holds F + S
        positions, and the logits are still the last text position's. The
        hybrid family's shared attention is not windowed here, as in the
        reference's prefill. `pspec_fn` as in ``loss``."""
        logits, cache = transformer.forward(
            params, batch["tokens"], self.cfg,
            frontend_embeds=batch.get("frontend_embeds"),
            collect_cache=self.cfg.family not in ("ssm", "hybrid"),
            last_only=True, force=force, tp=self.tp, pspec_fn=pspec_fn)
        return logits[:, -1], cache

    def decode(self, params, cache, tokens, pos, long_context: bool = False,
               pspec_fn=None):
        """tokens (B,1), pos (B,) -> (logits (B,Vp) f32, cache). The cache
        is updated in place. An MoE layer routes the B tokens over every
        expert's capacity buffer (256 slots at least) and drops its
        auxiliary loss, as the reference's decode does. `long_context`
        gives the hybrid family's shared attention its sliding window, as
        the reference's flag does, and its cache decides it too: a ring of
        the window's slots (``cache_template`` past 2 x the window) sees
        the last `window` positions, a full-length cache all of them.
        Over a mesh of ranks the attention runs in the reference's
        ``decode_mode`` ('heads' or 'seq'), and an MoE layer routes the
        global batch's tokens. `pspec_fn`
        (``sharding_rules.activation_pspec_fn``) is the reference's
        argument; the ranks hold their activations' shards as they are, so
        the dense family reads nothing from it, and the MoE family its
        ``gather_weights``, the experts' layout, which must be that of the
        rank's shards."""
        mode = decode_mode(self.cfg, self.mesh) if self.tp else "heads"
        return transformer.decode_step(params, cache, tokens, pos, self.cfg,
                                       long_context=long_context, tp=self.tp,
                                       decode_mode=mode, pspec_fn=pspec_fn)

    # -- caches ----------------------------------------------------------
    def cache_template(self, batch: int, seq: int,
                       dtype: Optional[torch.dtype] = None,
                       device: DeviceLike = None):
        """A zeroed KV cache {'k', 'v': (L,B,seq,KV,hd)} (the dense and
        MoE families) on `device`
        (default: the model's; "meta" describes the cache without
        allocating it), in `dtype` (default: the parameter dtype). For the
        SSM family {'state': (L,B,nh,hd,N), 'conv': (L,B,k-1,C)}, f32 whatever
        `dtype`, and independent of `seq`. For the hybrid family that SSM
        cache and {'ak', 'av': (sites,B,s_attn,KV,hd)} in `dtype`, where
        s_attn is the reference's rule: `seq`, or, for long-context serving
        (`seq` > 2 x the window), a ring of ``cfg.sliding_window`` slots,
        over which decode sees the last `window` positions. Over a mesh of
        ranks it is the rank's shard of that cache (``cache_pspecs`` for a
        batch of `batch` sequences of `seq`): the state's heads split as
        the rules split them, the conv history whole. A hybrid's cache on a
        grid whose model axis does not divide its kv heads is refused
        (``transformer._serving_on_mesh``)."""
        cfg = self.cfg
        dt = dtype or self.param_dtype
        dev = self.device if device is None else torch.device(device)
        if self.tp is not None:
            transformer._serving_on_mesh(cfg, self.tp)
            specs = self.cache_pspecs(ShapeConfig("cache", "decode", seq,
                                                  batch))

            def shard(name, shape):
                return tuple(n // split_size(self.mesh, ax)
                             for n, ax in zip(shape, specs[name]))
        else:
            def shard(name, shape):
                return shape
        kv = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        if cfg.family in ("ssm", "hybrid"):
            rows = shard("conv", (1, batch, 1, 1))[1]
            out = ssm.ssm_cache_template(cfg, rows, dev,
                                         layers=(cfg.num_layers,), tp=self.tp)
            if cfg.family == "hybrid":
                window = cfg.sliding_window
                s_attn = min(seq, window) if seq > 2 * window else seq
                shape = shard("ak", (transformer.n_attn_sites(cfg), batch,
                                     s_attn) + kv[2:])
                out["ak"] = torch.zeros(shape, dtype=dt, device=dev)
                out["av"] = torch.zeros(shape, dtype=dt, device=dev)
            return out
        shape = shard("k", (cfg.num_layers,) + kv)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins for every model input of a cell
# ---------------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                model: Optional[Model] = None) -> dict:
    """Every input of a (config, shape) cell as a tensor on the meta device:
    the shapes of ``repro.models.model.input_specs`` and the torch
    counterparts of its dtypes, nothing allocated. train: tokens and
    targets (B,S) int32; prefill: tokens (B,S) int32; both with
    frontend_embeds (B,F,d) bf16 where the config has a frontend. decode:
    tokens (B,1) and pos (B,) int32 and `model`'s cache for S positions
    (bf16, the reference's default; the SSM state f32)."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device=meta)

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((B, S))}
        if shape.kind == "train":
            specs["targets"] = spec((B, S))
        if cfg.frontend != "none" and cfg.frontend_tokens:
            specs["frontend_embeds"] = spec(
                (B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token against a seq_len cache
    if model is None:
        raise ValueError("input_specs: a decode shape needs the model, "
                         "whose cache it describes")
    return {"tokens": spec((B, 1)), "pos": spec((B,)),
            "cache": model.cache_template(B, S, dtype=torch.bfloat16,
                                          device=meta)}
