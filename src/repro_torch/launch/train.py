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
reference computes in full f32). The mesh and ``jit`` plumbing of the
reference (``batch_pspec``, ``shardings_for``, ``jit_train_step``) waits
for the mesh work (ROADMAP A6); PyTorch runs the step eagerly.
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
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import Model
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim import OPTIMIZERS, SoddaSVRGConfig, make_sodda_svrg
from repro_torch.optim.optimizers import flat_chunks, tree_map


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    """The reference's settings that apply on one device. Its `remat` is
    the model's (``Model(remat=...)``, which the reference's step reads);
    `zero1` and `moe_layout` (how the experts' weights lie over a mesh)
    wait for the mesh work (ROADMAP A6)."""
    optimizer: str = "adamw"
    lr: float = 3e-4
    accum_steps: int = 1
    state_dtype: str = "float32"  # bfloat16 for the 1T-class archs
    grad_dtype: str = "float32"  # accumulation dtype


def make_optimizer(settings: TrainSettings):
    kwargs = {}
    if settings.optimizer in ("momentum", "adamw"):
        kwargs["state_dtype"] = getattr(torch, settings.state_dtype)
    return OPTIMIZERS[settings.optimizer](settings.lr, **kwargs)


def loss_and_grads(model: Model, params, batch, force: str = "auto"):
    """(loss, metrics, grads): ``model.loss`` at `params` on `batch` and
    its gradient for every parameter (a tree like `params`), all detached.
    `force` goes to the layers' kernel wrappers."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch, force=force)
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
    updated. `shape` names the cell, as in the
    reference."""
    opt = make_optimizer(settings)
    A = settings.accum_steps
    gdt = getattr(torch, settings.grad_dtype)

    def train_step(params, opt_state, batch, step):
        if A == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                                   device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            for i in range(A):
                mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = loss_and_grads(model, params, mb)
                # in place, and the micro-batch's tree dropped once added:
                # no third tree (a new sum) is alive
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.to(a.dtype))
                del g
                lsum = lsum + l
            for a in tree_leaves(grads):
                a.div_(A)
            loss = lsum / A
            metrics = {"ce": loss,
                       "aux": torch.zeros((), dtype=torch.float32,
                                          device=model.device)}
        gnorm = torch.sqrt(sum(square_sum(g) for g in tree_leaves(grads)))
        with torch.no_grad():
            new_params, new_state = opt.update(grads, opt_state, params,
                                               step)
        return new_params, new_state, dict(metrics, loss=loss,
                                           grad_norm=gnorm)

    return train_step, opt


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
