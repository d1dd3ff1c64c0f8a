"""The train step and the end-to-end training driver.

Counterpart of ``repro.launch.train``. ``make_train_step`` builds the
train step for (model x shape x settings): gradients by autograd through
``Model.loss`` (on the card the SSD scan's backward is its hand-written
kernel), gradient accumulation over ``accum_steps`` micro-batches summed
in ``grad_dtype``, any optimizer of ``repro_torch.optim``, and the
loss / grad-norm metrics. ``sodda_loop`` is the CLI's SODDA-SVRG loop.

Run directly for a training run (on the CUDA device; ``--device cpu``
runs it on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 20 --batch 8 --seq 2048

``main`` turns TF32 off for float32 matrix products and convolutions (the
reference computes in full f32).

Over a mesh of ranks (a ``Model`` built on a ``core.distributed.Mesh``)
the step is the one GSPMD makes of the reference's: each rank takes its
rows of the global batch (``batch_axes``: over 'data', or ('pod', 'data')
on a mesh with a 'pod' axis, or a prefix of them where the batch does
not divide them all, and for the SSM family over 'model' too when the
batch divides every axis), runs every family
tensor-parallel over 'model' (the MoE layers' experts in the layout
``TrainSettings.moe_layout`` names, which must be the model's; the SSM
layers on the rank's heads, or with rows over 'model' on every head,
``models.transformer``), sums the gradients over the axes its rows lie
on (a leaf split over 'data', an expert weight, is not summed: its shards
hold different entries; nor, with rows over 'model', is a leaf split over
'model', which the step gathered and reduce-scattered) and divides by the
number of row blocks, takes the grad norm counting every element once,
and updates with its ZeRO-1 shard of the optimizer state (over 'data'
alone: replicated over 'pod', each pod updating the same slices;
``optim.optimizers.zero1`` for sgd, momentum and adamw,
``adafactor(mesh=)`` for adafactor). The
layouts are the reference's, as data: ``batch_pspec`` and
``shardings_for``'s specs; ``jit_train_step`` is the reference's entry
point of the same name (PyTorch runs the step eagerly).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.sharding_rules import (MOE_LAYOUTS,
                                                    PartitionSpec as P,
                                                    activation_pspec_fn,
                                                    axis_names, batch_axes,
                                                    coordinate, data_axes,
                                                    split_size)
from repro_torch.models import Model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim import OPTIMIZERS, SoddaSVRGConfig, make_sodda_svrg
from repro_torch.optim.optimizers import (adafactor, flat_chunks, tree_map,
                                          zero1, zero1_dims, zero1_pspecs)


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The reference's settings. Its `remat` is the model's
    (``Model(remat=...)``, which the reference's step reads). `zero1`
    splits the optimizer state over a mesh's 'data' axis
    (``shardings_for``, and the step over a mesh of ranks); `moe_layout`
    is how the experts' weights lie over a mesh (``MOE_LAYOUTS``): the
    step over a mesh of ranks builds the reference's activation spec
    function from it, whose layout must be that of the model's
    ``rules_overrides``. Neither changes a step on one device."""
    optimizer: str = "adamw"
    lr: float = 3e-4
    accum_steps: int = 1
    zero1: bool = True
    state_dtype: str = "float32"  # bfloat16 for the 1T-class archs
    grad_dtype: str = "float32"  # accumulation dtype
    moe_layout: str = "gather"  # 'gather' | 'token_tp'


def make_optimizer(settings: TrainSettings):
    kwargs = {}
    if settings.optimizer in ("momentum", "adamw"):
        kwargs["state_dtype"] = getattr(torch, settings.state_dtype)
    return OPTIMIZERS[settings.optimizer](settings.lr, **kwargs)


def batch_pspec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> dict:
    """The batch's partition specs: its rows over ``batch_axes``."""
    axes = batch_axes(cfg, shape, mesh)
    b = axes if len(axes) > 1 else (axes[0] if axes else None)
    return {"tokens": P(b, None), "targets": P(b, None),
            **({"frontend_embeds": P(b, None, None)}
               if cfg.frontend != "none" and cfg.frontend_tokens else {})}


def shardings_for(model: Model, shape: ShapeConfig,
                  settings: TrainSettings):
    """(param specs, optimizer-state specs, batch specs, abstract params,
    abstract state): the reference's ``shardings_for`` as data, specs
    where it returns ``NamedSharding``s, the abstract trees on the meta
    device. A state leaf takes the spec of the first parameter (in leaf
    order) of its shape; adafactor's factored moments, which drop a
    parameter's last or second-to-last dim, the spec with that dim
    dropped; and with `zero1` 'data' on top (``zero1_pspecs``)."""
    mesh = model.mesh
    pspecs = model.pspecs()
    abs_params = model.abstract()
    abs_opt = make_optimizer(settings).init(abs_params)
    shape_to_spec = {}
    for leaf, spec in zip(tree_leaves(abs_params), tree_leaves(pspecs)):
        shp = tuple(leaf.shape)
        shape_to_spec.setdefault(shp, spec)
        specs = list(spec) + [None] * (len(shp) - len(spec))
        if len(shp) >= 2:
            shape_to_spec.setdefault(shp[:-1], P(*specs[:-1]))  # r
            shape_to_spec.setdefault(shp[:-2] + shp[-1:],
                                     P(*(specs[:-2] + specs[-1:])))  # c

    def opt_spec(leaf):
        base = shape_to_spec.get(tuple(leaf.shape), P())
        return zero1_pspecs(base, leaf.shape, mesh) if settings.zero1 \
            else base

    return (pspecs, tree_map(opt_spec, abs_opt),
            batch_pspec(model.cfg, shape, mesh), abs_params, abs_opt)


def loss_and_grads(model: Model, params, batch, force: str = "auto",
                   pspec_fn=None):
    """(loss, metrics, grads): ``model.loss`` at `params` on `batch` and
    its gradient for every parameter (a tree like `params`), all detached.
    `force` goes to the layers' kernel wrappers, `pspec_fn` to the
    model."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch, force=force, pspec_fn=pspec_fn)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def square_sum(g):
    """The sum of g's squares in f32, over flat chunks of SLICE_ENTRIES
    entries (``flat_chunks``, the chunks' sums added in order), so no f32
    copy of a whole bf16 expert leaf is made; a leaf of one chunk is
    summed whole, as the reference sums it."""
    total = 0
    for (c,) in flat_chunks(g):
        total = total + torch.sum(torch.square(c.float()))
    return total


def _gradients(model: Model, params, batch, A: int, gdt, pspec_fn=None,
               rows=None):
    """(loss, metrics, grads) of `batch`: whole, or with A > 1 summed
    over A micro-batches in `gdt` and divided by A. `rows` (over a mesh)
    cuts a batch to the rank's rows: the global batch, or each of its
    micro-batches, so that a micro-batch is the reference's (its rows of
    the global batch), which an MoE layer routes as one batch."""
    rows = rows or (lambda b: b)
    if A == 1:
        return loss_and_grads(model, params, rows(batch), pspec_fn=pspec_fn)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                           device=p.device), params)
    lsum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(A):
        mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
              for k, v in batch.items()}
        l, _, g = loss_and_grads(model, params, rows(mb), pspec_fn=pspec_fn)
        # in place, and the micro-batch's tree dropped once added: no
        # third tree (a new sum) is alive
        for a, b in zip(tree_leaves(grads), tree_leaves(g)):
            a.add_(b.to(a.dtype))
        del g
        lsum = lsum + l
    for a in tree_leaves(grads):
        a.div_(A)
    loss = lsum / A
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                 device=model.device)}, grads


def make_train_step(model: Model, shape: ShapeConfig,
                    settings: TrainSettings):
    """(train_step, opt). ``train_step(params, opt_state, batch, step) ->
    (new_params, new_state, metrics)`` with metrics ``loss``, ``ce``,
    ``aux`` and ``grad_norm`` (f32 scalar tensors, on the device: reading
    one waits for the step). With ``accum_steps`` A > 1 the batch is split
    into A micro-batches along its first axis, their gradients summed in
    ``grad_dtype`` (in place: 0 + g1 + g2 ..., in order) and divided by A,
    and the loss is their mean, as the reference's scan does. The grad
    norm sums each leaf's squares (``square_sum``). The optimizer writes
    the new parameters and state into the trees it is given
    (``repro_torch.optim``), so `params` and `opt_state` come back
    updated. `shape` names the cell, as in the reference.

    Over a mesh of ranks the step is ``mesh_grads`` then the update: each
    rank passes its shards of the parameters and its ZeRO-1 state
    (``opt.init`` of its shards builds it), and the global batch, of
    which it takes its rows."""
    opt = make_optimizer(settings)
    if model.tp is not None:
        return _mesh_train_step(model, shape, settings, opt)
    A = settings.accum_steps
    gdt = getattr(torch, settings.grad_dtype)

    def train_step(params, opt_state, batch, step):
        loss, metrics, grads = _gradients(model, params, batch, A, gdt)
        gnorm = torch.sqrt(sum(square_sum(g) for g in tree_leaves(grads)))
        with torch.no_grad():
            new_params, new_state = opt.update(grads, opt_state, params,
                                               step)
        return new_params, new_state, dict(metrics, loss=loss,
                                           grad_norm=gnorm)

    return train_step, opt


def rank_rows(model: Model, shape: ShapeConfig, batch, axes=None):
    """This rank's rows of the global `batch`: its block along the axes
    the batch is split over (`axes`, by default ``batch_axes``; all rows
    when none), in the reference's order, the first axis major: over
    ('data', 'model') the block at data-rank x model-size + model-rank,
    over ('pod', 'data') pod x data-size + data-rank, over ('pod', 'data',
    'model') (pod x data-size + data-rank) x model-size + model-rank."""
    mesh = model.mesh
    if axes is None:
        axes = batch_axes(model.cfg, shape, mesh)
    axes = axis_names(axes)
    if not axes:
        return batch
    n, k = split_size(mesh, axes), coordinate(mesh, axes)
    return {name: v.chunk(n)[k] for name, v in batch.items()}


def mesh_pspec_fn(model: Model, shape: ShapeConfig, settings: TrainSettings):
    """The reference's activation spec function of a step over a mesh:
    the layout ``settings.moe_layout`` names (``MOE_LAYOUTS``)."""
    if settings.moe_layout not in MOE_LAYOUTS:
        raise ValueError(f"moe_layout must be one of {sorted(MOE_LAYOUTS)}, "
                         f"got {settings.moe_layout!r}")
    return activation_pspec_fn(model.cfg, shape, model.mesh,
                               MOE_LAYOUTS[settings.moe_layout])


def mesh_grads(model: Model, params, batch, shape: ShapeConfig,
               settings: TrainSettings):
    """(metrics, grads) of a step over a mesh of ranks, before its
    update: the rank's gradients of its rows of the global `batch` (of
    its parameter shards), then ``sum_over_data``."""
    A = settings.accum_steps
    micro = dataclasses.replace(shape, global_batch=shape.global_batch // A)
    loss, metrics, grads = _gradients(
        model, params, batch, A, getattr(torch, settings.grad_dtype),
        mesh_pspec_fn(model, micro, settings),
        rows=lambda b: rank_rows(model, micro, b))
    return sum_over_data(model, loss, metrics, grads,
                         axes=batch_axes(model.cfg, micro, model.mesh))


def _axes(spec):
    return {a for s in spec for a in axis_names(s)}


def sum_over_data(model: Model, loss, metrics, grads, axes=None):
    """(metrics, grads): the rank's `grads` (of its rows) summed over the
    axes its rows lie over (`axes`, ``batch_axes``' of the step; by
    default the data axes, ``data_axes``: 'data', or 'pod' and 'data'),
    axis by axis, and divided by the number of row blocks, in place (a
    leaf split over one of them, whose shards hold different entries, is
    divided only: its rank's gradient already sums every rank's share,
    through the reduce-scatters of the MoE layouts and, with the SSM
    family's rows over 'model' too, of the leaves the step gathered over
    'model'; the sum over 'pod' is tagged 'pod_grads', and the 'pod_grad'
    control drops it); the loss and the metrics averaged over the row
    blocks; and ``grad_norm`` counting every element once (each leaf's
    squares summed over every axis that splits it, a replicated leaf's
    taken once)."""
    mesh = model.mesh
    if axes is None:
        axes = data_axes(mesh)
    n = split_size(mesh, axes)
    specs = tree_leaves(model.pspecs())
    metrics = dict(metrics, loss=loss)
    controls = model.tp.controls
    if n > 1:
        for g, spec in zip(tree_leaves(grads), specs):
            for ax in axes:
                if ax in _axes(spec) or mesh.size(ax) == 1:
                    continue
                if ax == "pod":
                    if "pod_grad" not in controls:
                        mesh.all_reduce(g, ax, tag="pod_grads")
                else:
                    mesh.all_reduce(g, ax, tag="grads")
            g.div_(n)
        keys = sorted(metrics)
        both = torch.stack([metrics[k].float() for k in keys])
        for ax in axes:
            if mesh.size(ax) > 1:
                mesh.all_reduce(both, ax, tag="loss")
        metrics = dict(zip(keys, both / n))
    sums = {}  # the squares by the axes that split their leaves
    for g, spec in zip(tree_leaves(grads), specs):
        key = tuple(sorted(a for a in _axes(spec) if mesh.size(a) > 1))
        sums[key] = sums.get(key, torch.zeros(
            (), dtype=torch.float32, device=model.device)) + square_sum(g)
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for key in sorted(sums):
        for ax in key:
            mesh.all_reduce(sums[key], ax, tag="grad_norm")
        total = total + sums[key]
    metrics["grad_norm"] = torch.sqrt(total)
    return metrics, grads


def mesh_optimizer(model: Model, shape: ShapeConfig,
                   settings: TrainSettings, opt=None):
    """The optimizer of a step over a mesh of ranks: adafactor on the
    rank's shards (``adafactor(mesh=)``, its state laid by
    ``shardings_for``'s specs, ZeRO-1's under `zero1`), the others
    ``zero1``-wrapped under `zero1` (`opt`, or ``make_optimizer``'s)."""
    if settings.optimizer == "adafactor":
        return adafactor(settings.lr, mesh=model.mesh, pspecs=model.pspecs(),
                         state_pspecs=shardings_for(model, shape,
                                                    settings)[1],
                         zero1=settings.zero1)
    opt = opt or make_optimizer(settings)
    if settings.zero1:
        _, opt_specs, *_ = shardings_for(model, shape, settings)
        state = opt_specs["m"] if settings.optimizer == "adamw" else opt_specs
        if state != ():
            return zero1(opt, model.mesh, zero1_dims(state, model.pspecs()))
    return opt


def _mesh_train_step(model: Model, shape: ShapeConfig,
                     settings: TrainSettings, opt):
    opt = mesh_optimizer(model, shape, settings, opt)

    def train_step(params, opt_state, batch, step):
        metrics, grads = mesh_grads(model, params, batch, shape, settings)
        with torch.no_grad():
            new_params, new_state = opt.update(grads, opt_state, params,
                                               step)
        return new_params, new_state, metrics

    return train_step, opt


def jit_train_step(model: Model, shape: ShapeConfig,
                   settings: TrainSettings):
    """The reference's ``jit_train_step``: (train_step, opt, (abstract
    params, abstract state, param specs, state specs, batch specs)).
    PyTorch runs the step eagerly, so nothing is compiled: over a mesh of
    ranks the step is ``make_train_step``'s sharded one, and the specs
    are ``shardings_for``'s, which it follows."""
    step_fn, opt = make_train_step(model, shape, settings)
    param_sh, opt_sh, batch_sh, abs_params, abs_opt = shardings_for(
        model, shape, settings)
    return step_fn, opt, (abs_params, abs_opt, param_sh, opt_sh, batch_sh)


def sodda_loop(model: Model, params, pipeline: TokenPipeline, steps: int,
               lr: float, log_every: int = 10, log=print):
    """The CLI's SODDA-SVRG loop (``make_sodda_svrg`` with
    ``refresh_every=20``): each step draws a batch; at a refresh the
    snapshot gradient is taken on its first max(1, d_frac x B) rows; the
    update takes the gradient at the parameters and at the snapshot, on
    the whole batch. Returns (params, losses): the loss at the parameters
    on each step's batch, before its update (the gradient's own forward;
    the reference logs a third forward after the update)."""
    svrg = make_sodda_svrg(SoddaSVRGConfig(lr=lr, refresh_every=20))
    state = svrg["init"](params)
    losses = []
    for step in range(steps):
        batch = pipeline.next()
        if step % svrg["cfg"].refresh_every == 0:
            d = max(1, int(svrg["cfg"].d_frac * pipeline.batch))
            sub = {k: v[:d] for k, v in batch.items()}
            state = svrg["refresh"](state, params, loss_and_grads(
                model, params, sub)[2])
        loss, _, g1 = loss_and_grads(model, params, batch)
        g0 = loss_and_grads(model, state["snap"], batch)[2]
        with torch.no_grad():
            params, state = svrg["update"](params, state, g1, g0)
        losses.append(float(loss))
        if step % log_every == 0:
            log(f"step {step} loss {losses[-1]:.4f}")
    return params, losses


class TrainRun(NamedTuple):
    params: dict
    losses: List[float]  # each step's loss, from step 0 (a resume included)
    seconds: float  # this process's loop


def _restore(directory: str, params, opt_state, device):
    """(step, params, opt_state, extra) of the latest committed checkpoint,
    its leaves back on `device` in the templates' dtypes."""
    step, tree, extra = restore_checkpoint(
        directory, {"params": params, "opt_state": opt_state})

    def back(arr, like):
        return torch.from_numpy(np.array(arr)).to(device=device,
                                                   dtype=like.dtype)

    if isinstance(opt_state, dict):  # sgd's state is the empty tuple
        opt_state = tree_map(back, tree["opt_state"], opt_state)
    return step, tree_map(back, tree["params"], params), opt_state, extra


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=list(OPTIMIZERS) + ["sodda"])
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-sized)")
    ap.add_argument("--ckpt_dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt_every", type=int, default=25)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest committed checkpoint in "
                         "--ckpt_dir (params, optimizer state, pipeline, "
                         "losses) up to --steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.resume and args.optimizer == "sodda":
        ap.error("--resume: the sodda loop keeps no checkpoint")
    if args.resume and latest_step(args.ckpt_dir) is None:
        ap.error(f"--resume: no committed checkpoint in {args.ckpt_dir}")

    # full f32 products: no TF32 in matmuls or (cuDNN) convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg, seq_chunk=min(64, args.seq))
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    model = Model(cfg, device=args.device, param_dtype=torch.float32)
    settings = TrainSettings(
        optimizer=args.optimizer if args.optimizer != "sodda" else "sgd",
        lr=args.lr)
    pipeline = TokenPipeline(seed=0, batch=args.batch, seq_len=args.seq,
                             vocab_size=cfg.vocab_size, device=model.device)
    params = model.init(0)

    if args.optimizer == "sodda":
        t0 = time.perf_counter()
        params, losses = sodda_loop(model, params, pipeline, args.steps,
                                    args.lr, args.log_every)
        return TrainRun(params, losses, time.perf_counter() - t0)

    step_fn, opt = make_train_step(model, shape, settings)
    opt_state = opt.init(params)
    ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
    start, losses = 0, []
    if args.resume:
        start, params, opt_state, extra = _restore(args.ckpt_dir, params,
                                                   opt_state, model.device)
        pipeline.load_state_dict(extra["pipeline"])
        losses = list(extra["losses"])
        print(f"resumed at step {start} from {args.ckpt_dir}")
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = pipeline.next()
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.perf_counter() - t0):.1f}s)")
        # the reference saves the params; the optimizer state and the
        # losses are kept too, so that a resume continues the same run
        ckpt.maybe_save(step + 1, {"params": params, "opt_state": opt_state},
                        {"pipeline": pipeline.state_dict(),
                         "losses": losses})
    seconds = time.perf_counter() - t0
    print(f"done: {args.steps - start} steps in {seconds:.1f}s")
    return TrainRun(params, losses, seconds)


if __name__ == "__main__":
    main()
