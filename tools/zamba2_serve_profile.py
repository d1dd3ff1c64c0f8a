#!/usr/bin/env python3
"""Where the time of a zamba2-7b serving call goes, on the card.

    python3 tools/zamba2_serve_profile.py

Builds the port's kernels, draws full-size bf16 zamba2-7b (81 layers, 13
sites of the shared attention block) from seed 0 on the card, and traces
with ``torch.profiler`` (CPU and CUDA activities) one prefill of 4 x 4096
prompt tokens, then 4 decode steps over a 4 x 288 cache, each after a
warm-up call. For each it prints the wall time (host clock around work
that ends in a synchronise), the device time summed over kernels, the
device's idle share (1 - busy / wall; kernels do not overlap on one
stream), the device time by class (cuBLAS's GEMMs and GEMVs, the flash
and SSD kernels, copies and dtype casts, reductions, other elementwise
kernels) and the 15 kernels with the most device time. The profiler
slows the host, so under it eager decode's wall time, and its idle share,
are larger than unprofiled (``chip_smoke.py`` times decode alone). If
the profiler records no device time, it says so and exits non-zero: then
time with CUDA events instead. Needs a CUDA device and nvcc; imports
nothing of JAX.
"""
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
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402
from repro_torch.models import Model  # noqa: E402

B, PROMPT, CACHE, DECODE_STEPS = 4, 4096, 288, 4


def classify(name: str) -> str:
    low = name.lower()
    if "flash_wgmma" in low or "flash_attention" in low:
        return "flash"
    if "ssd" in low:
        return "ssd"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                                "splitkreduce")):
        return "cuBLAS"
    if "copy" in low:
        return "copies and casts"
    if "reduce_kernel" in low:
        return "reductions"
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
                                       key=lambda kv: -kv[1])))
    for e in sorted(rows, key=device_us, reverse=True)[:15]:
        print(f"  {device_us(e) / 1e3:10.3f} ms  {e.count:6d} calls  "
              f"[{classify(e.key)}] {e.key[:110]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("zamba2_serve_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kbuild.build_all([*flash_build.SOURCES, *ssd_build.SOURCES])
    cfg = get_config("zamba2-7b")
    model = Model(cfg)
    params = model.init(0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                            device="cuda")
    batch = {"tokens": prompts}

    model.prefill(params, batch)  # warm-up: handles, libraries
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"prefill {B} x {PROMPT}", prof, wall)

    cache = model.cache_template(B, CACHE)
    tok = prompts[:, :1]
    pos = torch.full((B,), CACHE - DECODE_STEPS - 2, dtype=torch.long,
                     device="cuda")
    model.decode(params, cache, tok, pos)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS):
            model.decode(params, cache, tok, pos + 1 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(f"{DECODE_STEPS} decode steps, batch {B}, cache {CACHE}", prof,
           wall)


if __name__ == "__main__":
    main()
