#!/usr/bin/env python3
"""Where the time of an MoE serving call goes, on the card.

    python3 tools/moe_serve_profile.py

Builds the flash kernels, then for arctic-480b cut to 2 of its 35 layers
(all 128 experts, the dense residual) and kimi-k2 cut to 1 of its 61 (all
384 experts), each at full width in bf16 from seed 0, one model on the
card at a time: times the first prefill of 4 x 4064 prompt tokens after a
256-token warm-up (``chip_smoke.py``'s earlier warm-up), then 5 more
(host clock around work that ends in a synchronise; their median), then
8 decode steps over a 4 x 4096 cache (the median step), and traces one
prefill and 4 decode steps with ``torch.profiler`` (CPU and CUDA
activities). For each trace it prints the wall time, the device time
summed over kernels, the device's idle share (1 - busy / wall), the
device time by class (cuBLAS's GEMMs, which run the expert products
batched over the capacity slots; the flash kernel; the routing's sorts
and scans; gathers and concatenations; copies and casts; other
elementwise kernels) and the 12 kernels with the most device time. The
profiler slows the host, so traced walls and idle shares are larger than
untraced. If the profiler records no device time, it says so and exits
non-zero. Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as flash_build  # noqa: E402
from repro_torch.models import Model  # noqa: E402

B, PROMPT, GEN, DECODE_STEPS = 4, 4064, 32, 8
CELLS = (("arctic-480b", 2), ("kimi-k2-1t-a32b", 1))


def classify(name: str) -> str:
    low = name.lower()
    if "flash_wgmma" in low or "flash_attention" in low:
        return "flash"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                "splitkreduce")):
        return "cuBLAS"
    if any(k in low for k in ("sort", "scan", "searchsorted", "histogram",
                                "bincount")):
        return "routing sorts and scans"
    if any(k in low for k in ("gather", "index", "scatter", "catarray")):
        return "gathers and concatenations"
    if "copy" in low:
        return "copies and casts"
    if "reduce_kernel" in low or "softmax" in low:
        return "reductions and softmax"
    return "elementwise"


def device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def report(title, prof, wall_s):
    rows = [e for e in prof.key_averages() if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(device_us(e) for e in rows) / 1e3  # ms
    if busy == 0:
        raise SystemExit(f"{title}: the profiler recorded no device time; "
                         "time with CUDA events instead")
    wall = 1e3 * wall_s
    by_class = {}
    for e in rows:
        k = classify(e.key)
        by_class[k] = by_class.get(k, 0.0) + device_us(e) / 1e3
    print(f"{title}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {max(0.0, 1 - busy / wall):.4f}; by class (ms, share of "
          "busy): " + ", ".join(f"{k} {v:.3f} ({v / busy:.2%})" for k, v in
                                sorted(by_class.items(),
                                       key=lambda kv: -kv[1])), flush=True)
    for e in sorted(rows, key=device_us, reverse=True)[:12]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d} calls  "
              f"[{classify(e.key)}] {e.key[:100]}", flush=True)


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def cell(name, layers):
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    model = Model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            device="cuda")
    tag = f"{name} ({layers} of {get_config(name).num_layers} layers)"
    model.prefill(params, {"tokens": prompts[:, :256]})
    first = wall_ms(lambda: model.prefill(params, {"tokens": prompts}))
    steady = [wall_ms(lambda: model.prefill(params, {"tokens": prompts}))
              for _ in range(5)]
    print(f"{tag} prefill {B} x {PROMPT}: first full-size call "
          f"{first:.3f} ms, then {', '.join(f'{t:.3f}' for t in steady)} "
          f"ms (median {statistics.median(steady):.3f})", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"{tag} prefill {B} x {PROMPT}", prof, wall)

    cache = model.cache_template(B, PROMPT + GEN)
    tok = prompts[:, :1]
    pos = torch.full((B,), PROMPT, dtype=torch.long, device="cuda")
    model.decode(params, cache, tok, pos)  # warm-up
    steps = [wall_ms(lambda: model.decode(params, cache, tok, pos + 1 + i))
             for i in range(DECODE_STEPS)]
    print(f"{tag} decode, batch {B}, cache {PROMPT + GEN}: median step "
          f"{statistics.median(steps):.3f} ms of {DECODE_STEPS}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(4):
            model.decode(params, cache, tok, pos + 1 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"{tag} 4 decode steps", prof, wall)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("moe_serve_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kbuild.build_all(list(flash_build.SOURCES))
    for name, layers in CELLS:
        cell(name, layers)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
