#!/usr/bin/env python3
"""Where the time of a mamba2-130m training step goes, on the card.

    python3 tools/mamba2_train_profile.py

Builds the SSD kernels, draws full-size mamba2-130m in f32 from seed 0 on
the card (the CLI's init), and runs ``make_train_step`` (adamw, lr 3e-4)
on 8 x 2048 tokens a step from ``TokenPipeline(seed=0)``, as
``chip_smoke.py``'s training phase does. After 3 warm-up steps it times,
by CUDA events, 5 whole steps and then their parts on the same batch:
the loss's forward alone (grad mode on, as in training), the forward and
backward (``loss_and_grads``), and the optimizer's update. Then it traces
one step with ``torch.profiler`` (CPU and CUDA activities) and prints the
wall time, the device time summed over kernels, the device's idle share,
the device time by class (cuBLAS, the SSD forward and backward kernels,
copies and casts, reductions, other elementwise kernels) and the 15
kernels with the most device time (``zamba2_serve_profile.report``). TF32
is off, as in the CLI. Needs a CUDA device and nvcc; imports nothing of
JAX.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
import zamba2_serve_profile as serve_profile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402

B, S, LR, WARMUP, TIMED = 8, 2048, 3e-4, 3, 5
SERVE_CLASSIFY = serve_profile.classify


def classify(name: str) -> str:
    """``zamba2_serve_profile.classify``, with the SSD backward apart."""
    if "ssd_bwd" in name.lower():
        return "ssd backward"
    return SERVE_CLASSIFY(name)


def events_ms(fn, reps):
    """Mean ms of fn() by CUDA events around `reps` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mamba2_train_profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kbuild.build_all(list(ssd_build.SOURCES))
    cfg = get_config("mamba2-130m")
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
    step_ms = events_ms(one_step, TIMED)
    batch = pipe.next()
    fwd_ms = events_ms(lambda: model.loss(state["params"], batch), TIMED)
    grads = train.loss_and_grads(model, state["params"], batch)[2]
    fb_ms = events_ms(lambda: train.loss_and_grads(model, state["params"],
                                                   batch), TIMED)
    # update writes into the live weights and moments: each timed call
    # moves them, and the profiled step below runs on the moved ones (the
    # same work whatever their values)
    with torch.no_grad():
        opt_ms = events_ms(lambda: opt.update(grads, state["opt"],
                                              state["params"], 0), TIMED)
    tokens = B * S
    print(f"train step mamba2-130m f32 adamw, {B} x {S} tokens: "
          f"{step_ms:.3f} ms a step ({tokens / step_ms * 1e3:.1f} tokens/s; "
          f"mean of {TIMED} after {WARMUP} warm-up steps); forward alone "
          f"{fwd_ms:.3f} ms, forward + backward {fb_ms:.3f} ms (backward "
          f"{fb_ms - fwd_ms:.3f}), optimizer update {opt_ms:.3f} ms; the "
          f"rest of a step (grad norm, metrics) "
          f"{step_ms - fb_ms - opt_ms:.3f} ms", flush=True)

    serve_profile.classify = classify  # report() classifies through it
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    serve_profile.report(f"one train step, {B} x {S} tokens", prof, wall)


if __name__ == "__main__":
    main()
