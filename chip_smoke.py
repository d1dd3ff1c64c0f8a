#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) and nothing of the JAX package:

1. prints the card's name and power limit (``nvidia-smi``); fails without
   a CUDA device;
2. builds the hand-written ``sodda_inner`` kernel from the sources in the
   checkout and prints the build time and the compiler's register report;
3. holds the kernel against its plain PyTorch version on the card at the
   Table-1 shapes (15, 64, 1200) for all three losses and at an unaligned
   (2, 8, 100), requires two launches to agree bitwise, and times kernel
   and plain version with CUDA events beside the kernel's bound;
4. runs a small problem on the ``cuda`` backend against the ``reference``
   backend on the CPU, fed the same data and samples;
5. runs the paper's Table-1 instance (250 000 x 18 000, X = 18.0 GB on the
   card) through ``repro_torch.core.driver.run`` on the ``cuda`` backend —
   the main path, with the launch counts set to 0 just before it — and on
   the ``reference`` backend, checks descent, agreement, launches and peak
   device memory, and breaks one iteration down by layer.

Exits non-zero if any phase fails. The last three lines of standard output
are the card line, a JSON ``kernels`` record and a JSON ``ok`` record.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs.sodda_svm import SoddaConfig, TABLE1_250K_18K  # noqa: E402
from repro_torch.core import driver, losses, partition, sodda  # noqa: E402
from repro_torch.data.synthetic import make_svm_data  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sodda_inner as kernel_build  # noqa: E402
from repro_torch.testing import tolerances as tol  # noqa: E402

ITERS = 20  # outer iterations of each Table-1 run
RECORD_EVERY = 5
SEED = 0

# H100 SXM peaks (NVIDIA data sheet) for the kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# tests/test_kernels.py:35 — one kernel call against its plain version:
# the kernel hoists z0 and reduces in another order than the plain loop.
KERNEL_RTOL, KERNEL_ATOL = 3e-4, 2e-5
# Step size of the kernel-check inputs. Hinge and logistic have bounded
# derivatives; the squared loss's chain multiplies the x-direction by
# (1 - gamma*|x|^2) each step, so it needs gamma*|x|^2 < 2 (|x|^2 ~ mt).
KERNEL_GAMMA = {"hinge": 0.01, "logistic": 0.01, "squared": 1e-4}


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(B, L, mt, gen):
    """Inputs shaped like the main path's: unit-variance X rows, +-1
    labels, a small iterate and exchange vector."""
    dev = "cuda"
    Xl = (torch.rand(B, L, mt, generator=gen, device=dev) * 2 - 1) * 3 ** 0.5
    yl = torch.where(torch.rand(B, L, generator=gen, device=dev) < 0.5,
                     -1.0, 1.0)
    w0 = torch.randn(B, mt, generator=gen, device=dev) * 0.01
    mu = torch.randn(B, mt, generator=gen, device=dev) * 1e-3
    return w0, Xl, yl, mu


def kernel_bound_ms(B, L, mt):
    """Least time for one call: bytes (each input read once, the output
    written once) over HBM rate vs f32 operations over the f32 peak."""
    nbytes = 4 * (3 * B * mt + B * L * mt + B * L + 1)
    flops = 8.0 * B * L * mt  # z0 dots 2, per step dot 2 + update 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    for (B, L, mt) in ((15, 64, 1200), (2, 8, 100)):
        for loss in ("hinge", "logistic", "squared"):
            args = kernel_inputs(B, L, mt, gen)
            gamma = KERNEL_GAMMA[loss]
            a = ops.sodda_inner(*args, gamma, loss, force="cuda")
            b = ops.sodda_inner(*args, gamma, loss, force="cuda")
            want = ops.sodda_inner(*args, gamma, loss, force="ref")
            torch.cuda.synchronize()
            check(torch.equal(a, b),
                  f"sodda_inner {loss} {(B, L, mt)}: two launches differ")
            check(bool(torch.isfinite(a).all()),
                  f"sodda_inner {loss} {(B, L, mt)}: non-finite output")
            torch.testing.assert_close(a, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
            err = float((a - want).abs().max())
            max_err = max(max_err, err)
            log(f"kernel {loss:8s} {(B, L, mt)}: bitwise across launches, "
                f"max|kernel-plain| = {err:.3e}")

    B, L, mt = 15, 64, 1200  # Table-1: P*Q chains of L rows, m_tilde wide
    args = kernel_inputs(B, L, mt, gen)
    ms = cuda_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                         force="cuda"), reps=200)
    plain_ms = cuda_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                               force="ref"), reps=10)
    bound_ms, bound_by = kernel_bound_ms(B, L, mt)
    log(f"kernel sodda_inner (15, 64, 1200) hinge: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return dict(name="sodda_inner", route="cuda",
                source="src/repro_torch/kernels/csrc/sodda_inner.cu",
                replaces="src/repro/kernels/sodda_inner.py:75",
                launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def phase_small():
    """The cuda backend on the card against the reference backend on the
    CPU: same data, same samples (drawn on the CPU and copied over)."""
    for loss in ("hinge", "logistic", "squared"):
        cfg = SoddaConfig(name=f"smoke-small-{loss}", loss=loss, P=4, Q=3,
                          n=500, m=120, L=8,
                          lr0=0.02 if loss == "squared" else 0.05)
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        X, y, _ = make_svm_data(gen, cfg.N, cfg.M, device="cpu")
        b, c, d = sodda._counts(cfg)

        def sampler_on(dev):
            def sampler(t):
                s = partition.sample_iteration(SEED, t, cfg.P, cfg.Q, cfg.n,
                                               cfg.M, cfg.L, b, c, d, "cpu")
                return partition.IterationSample(*(f.to(dev) for f in s))
            return sampler

        ref_state, ref_hist = driver.run(SEED, (X, y), cfg, 10, "reference",
                                         record_every=2, device="cpu",
                                         sampler=sampler_on("cpu"))
        state, hist = driver.run(SEED, (X.cuda(), y.cuda()), cfg, 10, "cuda",
                                 record_every=2, device="cuda",
                                 sampler=sampler_on("cuda"))
        tol.assert_trajectories_close([ref_state.w.numpy()],
                                      [state.w.cpu().numpy()],
                                      tol.F32_REDUCTION, f"small {loss}")
        for (t, f_ref), (_, f) in zip(ref_hist, hist):
            tol.assert_objectives_close(f_ref, f, tol.F32_REDUCTION,
                                        f"small {loss} t={t}")
        check(hist[-1][1] < hist[0][1], f"small {loss}: no descent {hist}")
        log(f"small {loss:8s} cuda vs cpu reference: F32_REDUCTION holds, "
            f"F {hist[0][1]:.6f} -> {hist[-1][1]:.6f}")


def phase_breakdown(cfg, X, y, w):
    """Device time of each layer of one Table-1 iteration (CUDA events)."""
    b, c, d = sodda._counts(cfg)

    def draw():
        return partition.sample_iteration(SEED, 7, cfg.P, cfg.Q, cfg.n,
                                          cfg.M, cfg.L, b, c, d, X.device)

    smp = draw()
    mu = sodda.snapshot_gradient(cfg.loss, X, y, w, smp, cfg.P * d)
    gamma = float(sodda._gamma(cfg, 7))
    parts = {
        "sample_iteration": cuda_ms(draw, reps=10),
        "snapshot_gradient (2 GEMVs)": cuda_ms(
            lambda: sodda.snapshot_gradient(cfg.loss, X, y, w, smp,
                                            cfg.P * d), reps=10),
        "consume_update (gather + kernel + concat)": cuda_ms(
            lambda: sodda.consume_update(X, y, w, mu, smp, gamma, cfg, True),
            reps=10),
        "objective (1 GEMV)": cuda_ms(
            lambda: losses.objective(cfg.loss, X, y, w), reps=10),
    }
    for name, ms in parts.items():
        log(f"breakdown {name}: {ms:.4f} ms")
    return parts


def phase_table1(cfg):
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    X, y, _ = make_svm_data(gen, cfg.N, cfg.M)
    torch.cuda.synchronize()
    x_bytes = X.numel() * X.element_size()
    log(f"table1 data {cfg.N} x {cfg.M} generated on the card in "
        f"{time.perf_counter() - t0:.3f} s; X = {x_bytes / 1e9:.3f} GB")
    check(bool(torch.isfinite(X[:1000]).all()), "non-finite data")

    for backend in ("cuda", "reference"):  # warm-up: cuBLAS handles etc.
        driver.run(SEED, (X, y), cfg, 2, backend, record_every=2)
    runs = {}
    for backend in ("cuda", "reference"):
        if backend == "cuda":
            ops.sodda_inner.launches = 0  # the main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = driver.run(SEED, (X, y), cfg, ITERS, backend,
                                 record_every=RECORD_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if backend == "cuda":
            launches = ops.sodda_inner.launches  # ... and ends here
        runs[backend] = (state, hist, 1e3 * wall / ITERS)
        log(f"table1 {backend:9s}: {1e3 * wall / ITERS:.3f} ms/iteration "
            f"over {ITERS} iterations (objective every {RECORD_EVERY}); "
            f"history {[(t, round(f, 6)) for t, f in hist]}")

    check(launches == ITERS,
          f"sodda_inner launched {launches} times in {ITERS} iterations")
    (st_c, h_c, ms_c), (_, h_r, _) = runs["cuda"], runs["reference"]
    check(all(math.isfinite(f) for _, f in h_c), f"non-finite objective {h_c}")
    check(h_c[-1][1] < h_c[0][1], f"objective did not descend: {h_c}")
    check(bool(torch.isfinite(st_c.w).all()), "non-finite iterate")
    # Hinge's derivative is a step at y*z = 1, so the kernel's reduction
    # order may flip a branch in a long trajectory: hold hinge at the
    # objective level (F32_REDUCTION's obj_rel), and the logistic twin below
    # to the full F32_REDUCTION trajectory policy.
    for (t, f_r), (_, f_c) in zip(h_r, h_c):
        tol.assert_objectives_close(f_r, f_c, tol.F32_REDUCTION,
                                    f"table1 hinge t={t}")
    log("table1 hinge: cuda and reference histories agree (F32_REDUCTION "
        "objective level)")

    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    ws, hs = [], []
    for backend in ("cuda", "reference"):
        st, h = driver.run(SEED, (X, y), lcfg, ITERS, backend,
                           record_every=RECORD_EVERY)
        ws.append(st.w.cpu().numpy())
        hs.append(h)
    tol.assert_trajectories_close([ws[1]], [ws[0]], tol.F32_REDUCTION,
                                  "table1 logistic final w")
    for (t, f_r), (_, f_c) in zip(hs[1], hs[0]):
        tol.assert_objectives_close(f_r, f_c, tol.F32_REDUCTION,
                                    f"table1 logistic t={t}")
    log(f"table1 logistic twin: F32_REDUCTION holds, F {hs[0][0][1]:.6f} -> "
        f"{hs[0][-1][1]:.6f}")

    peak = torch.cuda.max_memory_allocated()
    log(f"table1 peak device memory {peak / 1e9:.3f} GB = "
        f"{peak / x_bytes:.4f} x X")
    check(peak <= 1.1 * x_bytes, f"peak memory {peak} > 1.1 x X")
    return X, y, st_c.w, launches, ms_c


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA "
             "device")
    # full f32 GEMVs and no TF32 anywhere in the port
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib = kernel_build.build()
    log(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.with_name(lib.name + ".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  nvcc: {line.strip()}")

    record = phase_kernel()
    phase_small()
    cfg = TABLE1_250K_18K
    X, y, w, launches, ms_c = phase_table1(cfg)
    record["launches"] = launches
    log(f"table1 kernel share of a cuda-backend iteration: "
        f"{record['ms']:.4f} / {ms_c:.3f} ms = {record['ms'] / ms_c:.4%}")
    phase_breakdown(cfg, X, y, w)

    print(card)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
