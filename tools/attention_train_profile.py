#!/usr/bin/env python3
"""Where the time of a dense or hybrid training step goes, on the card.

    python3 tools/attention_train_profile.py [--arch gemma2-9b zamba2-7b]

Builds the flash-attention and SSD kernels, draws gemma2-9b cut to 4
layers and zamba2-7b cut to 12 layers (2 sites of its shared block), both
at full width, in f32 from seed 0 on the card (the CLI's init), and runs
``make_train_step`` (adamw, lr 3e-4) on B x 4608 tokens a step from
``TokenPipeline(seed=0)``, as ``chip_smoke.py``'s training cells do (B is
``chip_smoke.GEMMA2_TRAIN_B`` and ``ZAMBA2_TRAIN_B``). After a warm-up
step it times, by CUDA events, 3 whole steps and then their parts on one
batch: the loss's forward alone (grad mode on), the forward and backward
(``loss_and_grads``) and the optimizer's update. Then it traces one step
with ``torch.profiler`` and prints the wall time, the device's busy time
and idle share, the device time by class (cuBLAS, the flash forward and
backward kernels, the SSD forward and backward kernels, copies and casts,
reductions, other elementwise kernels) and the 15 kernels with the most
device time (``zamba2_serve_profile.report``). TF32 is off, as in the CLI.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import mamba2_train_profile as train_profile  # noqa: E402
import zamba2_serve_profile as serve_profile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as flash_build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402

S, LR, WARMUP, TIMED = chip_smoke.ATTN_TRAIN_S, 3e-4, 1, 3
CELLS = {"gemma2-9b": (chip_smoke.GEMMA2_TRAIN_LAYERS,
                       chip_smoke.GEMMA2_TRAIN_B),
         "zamba2-7b": (chip_smoke.ZAMBA2_TRAIN_LAYERS,
                       chip_smoke.ZAMBA2_TRAIN_B)}


def classify(name: str) -> str:
    """``mamba2_train_profile.classify``, with the flash kernels apart:
    the backward's three kernels and the forward."""
    low = name.lower()
    if "flash_bwd" in low:
        return "flash backward"
    if "flash" in low:
        return "flash forward"
    return train_profile.classify(name)


def profile_cell(arch):
    layers, B = CELLS[arch]
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = Model(cfg, param_dtype=torch.float32)
    step_fn, opt = train.make_train_step(
        model, ShapeConfig("profile", "train", S, B),
        train.TrainSettings(optimizer="adamw", lr=LR))
    state = {"params": model.init(0), "step": 0}
    state["opt"] = opt.init(state["params"])
    pipe = TokenPipeline(seed=0, batch=B, seq_len=S,
                         vocab_size=cfg.vocab_size)

    def one_step(batch=None):
        state["params"], state["opt"], metrics = step_fn(
            state["params"], state["opt"], batch or pipe.next(),
            state["step"])
        state["step"] += 1
        return metrics

    for _ in range(WARMUP):
        one_step()
    torch.cuda.synchronize()
    step_ms = train_profile.events_ms(one_step, TIMED)
    batch = pipe.next()
    fwd_ms = train_profile.events_ms(
        lambda: model.loss(state["params"], batch), TIMED)
    fb_ms = train_profile.events_ms(
        lambda: train.loss_and_grads(model, state["params"], batch), TIMED)
    grads = train.loss_and_grads(model, state["params"], batch)[2]
    # update writes into the live weights and moments: each timed call
    # moves them, and the profiled step below runs on the moved ones (the
    # same work whatever their values)
    with torch.no_grad():
        opt_ms = train_profile.events_ms(
            lambda: opt.update(grads, state["opt"], state["params"], 0),
            TIMED)
    del grads
    tokens = B * S
    print(f"train step {arch} ({layers} layers, full width) f32 adamw, "
          f"{B} x {S} tokens: {step_ms:.3f} ms a step "
          f"({tokens / step_ms * 1e3:.1f} tokens/s; mean of {TIMED} after "
          f"{WARMUP} warm-up step); forward alone {fwd_ms:.3f} ms, forward "
          f"+ backward {fb_ms:.3f} ms (backward {fb_ms - fwd_ms:.3f}), "
          f"optimizer update {opt_ms:.3f} ms; the rest of a step (grad "
          f"norm, metrics) {step_ms - fb_ms - opt_ms:.3f} ms", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    serve_profile.report(f"one {arch} train step, {B} x {S} tokens", prof,
                         wall)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", nargs="+", default=list(CELLS),
                        choices=list(CELLS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attention_train_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kbuild.build_all([*flash_build.SOURCES, *ssd_build.SOURCES])
    serve_profile.classify = classify  # report() classifies through it
    for arch in args.arch:
        profile_cell(arch)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
