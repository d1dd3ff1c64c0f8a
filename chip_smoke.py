#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) and nothing of the JAX package:

1. prints the card's name and power limit (``nvidia-smi``); fails without
   a CUDA device;
2. builds the hand-written kernels (``sodda_inner``, ``flash_attention``
   and ``ssd_scan``, each of the last two in a wgmma source for bf16 and a
   CUDA-core source for f32) from the sources in the checkout, one
   ``nvcc`` per source, all at once, and prints the build time and the
   compiler's register report;
3. holds ``sodda_inner`` against its plain PyTorch version on the card for
   all three losses at the Table-1 widths (15, 64, 1200), (15, 64, 1400)
   and (15, 64, 1800), at an unaligned (2, 8, 100), at a row pitch that is
   no multiple of 16 bytes (3, 5, 301), at L = 1, above the register
   buckets (3, 16, 2100) and at the largest mt the first slice's kernel
   took, (2, 3, 19344); requires two launches to agree bitwise; times the
   kernel by a CUDA graph of launches (the kernel alone) beside its bound,
   the wrapper's host time a call, CUDA events around back-to-back wrapper
   calls (the earlier method) and the plain version;
4. runs a small problem on the ``cuda`` backend against the ``reference``
   backend on the CPU, fed the same data and samples;
5. runs the paper's Table-1 instance (250 000 x 18 000, X = 18.0 GB on the
   card) through ``repro_torch.core.driver.run`` on the ``cuda`` backend —
   the main path, with the launch counts set to 0 just before it — and on
   the ``reference`` backend, checks descent, agreement, launches and peak
   device memory, and breaks one iteration down by layer, consume_update
   into its gather, kernel and concatenation; then frees X;
6. materialises the ``tiled`` data plane of Table-1 on the card, prints
   its time and its peak device memory over X (at most 1.1 x X), and holds
   one tile and one label block bitwise to the same blocks regenerated
   alone;
7. holds ``sodda_inner`` at radisa-avg's launch (15, 64, 6000) against its
   plain version for all three losses, bitwise across launches, and times
   it by a CUDA graph beside its bound;
8. runs ``radisa-avg`` and ``async`` for 20 iterations each through
   ``driver.run`` on that data, with the launch counts set to 0 just
   before each: 20 launches each, radisa-avg within F32_REDUCTION of its
   plain path (hinge at each iteration, kernel and plain stepped from the
   same state, and the hinge trajectory at the objective level against the
   plain path rounded as the kernel rounds, with fused multiply-adds; a
   logistic twin's trajectory in full),
   async at staleness 0 bitwise ``cuda``'s trajectory and at staleness 1
   within STALENESS of it, descent everywhere; then prints the paper's
   comparison, SODDA against RADiSA-avg per iteration, per gradient
   coordinate and per second (no gate);
9. drives ``driver.run_resumable`` on that data (20 iterations, 2
   segments of 10, the launch counts set to 0 just before each run and
   read just after): bitwise ``driver.run`` back to back; a ``cuda`` run
   killed after its first boundary, and one killed at a mid-segment commit
   (``commit_every=5``, at iteration 15), each resumed bitwise, as are
   ``async`` at staleness 1 and ``radisa-avg`` killed after a boundary;
   each run launches the kernel once an iteration it runs, a resume of a
   completed run never; ``replay_segment`` matches; the checkpoints are
   read back by hand (json, numpy, zlib) in the reference's layout; and
   it prints the ms an iteration against ``driver.run``'s, a save's ms and
   the data fingerprint's seconds;
10. holds ``sodda_inner`` at (12, 64, 1500) as in 7, then runs
    ``run_elastic`` on ``cuda``, shrinking P from 5 to 4 at iteration 10:
    20 launches, bitwise the same composition by hand
    (``migrate_resumable`` and ``run_resumable`` over ``shrink_plane``),
    descent;
11. holds epoch 0 of the ``streaming`` plane bitwise to the tiled X and a
    one-segment streaming run bitwise to the tiled run, times the static
    ``cuda`` run and frees X; then streams Table-1 as 4 windows (no tile
    cache, a window a segment of 5): prefetched at depth 1 and 2, each
    bitwise a loop here that materialises each window on the main stream
    with no thread, killed and resumed bitwise, with the ms an iteration,
    the prefetcher's accounting and the peak over X (at most 2.2 x X at
    depth 1);
12. runs Table-1 doubly distributed, before the streaming windows: on the
    tiled plane's X it records ``cuda``'s iterate at every iteration, the
    exchange of iterations 1 and 10, ``async`` at staleness 1 and the
    logistic twin; frees X; holds ``sodda_inner`` at the mesh's launch
    (1, 64, 1200), one chain a rank, as in 7; then spawns a 5 x 3 grid of
    15 ranks sharing the card over gloo (each draws only its 1.2 GB tile)
    for one spawn of every mesh run, 20 iterations each, objective every
    5, the launch counts set to 0 just before each run in each rank:
    ``shard_map+cuda`` (the mesh's main path), ``async-mesh`` at staleness
    0 and 1, the int8 wires, the delta all-reduce, and ``run_resumable``
    interrupted at its seam and resumed. It holds every rank's w and
    history bitwise equal; one launch a rank an iteration, a resume only
    its own; ``consume_local`` bitwise ``consume_update``; every step from
    ``cuda``'s iterate and the trajectory (hinge, and the logistic twin)
    within F32_REDUCTION of ``cuda``; staleness 0 bitwise, staleness 1
    within STALENESS of ``async``; the int8 wires within QUANTIZED; the
    resume bitwise, rank 0 alone writing; and prints the ms an iteration,
    each collective's payload beside ``iteration_collective_bytes``, the
    ranks' summed peak over X, the card's used memory, a ``shard_map+cuda``
    iteration by layer (the engine's bundle, the device synchronised
    around each collective) and one all-reduce of n f32 over all 15 ranks.
    Then a 1 x 1 grid over NCCL, bitwise ``cuda`` on the same data.
    Then the elastic rescale and the streaming plane on the mesh: with X
    still resident it records the single-device ``run_elastic`` runs
    (``cuda`` shrinking P from 5 to 4 at 10 and growing back at 15,
    ``async`` at staleness 1, the logistic twin) and the tile digests of
    the 4 stream windows' slices; holds ``sodda_inner`` at the shrunk
    mesh's launch (1, 64, 1500) as in 7; then spawns the 15 ranks and 6
    spare processes for one spawn of: ``shard_map+cuda`` streaming 4
    windows a segment of 5 at prefetch depth 1 and one window's run, each
    rank's tile of every window, the static runs beside them, then
    ``run_elastic`` shrinking to 4 x 3 at 10 and regrowing to 5 x 3 at 15
    (the lost row leaves the group, the survivors re-form it, 3 spares
    join as the regrown row; a fault after its last commit), the same by
    hand (``run_resumable``, the group re-formed, ``rescale_bundle``,
    ``migrate_resumable``, ``run_resumable``), the shrink with a fault
    after a commit in each phase and by hand, ``run_elastic_auto`` with
    the last rank's segment from 5 read as 30 s slow, ``async-mesh`` and
    the logistic twin, the launch counts set to 0 just before each run in
    each process. It holds every rank's w, history and report bitwise
    equal; the planned departures and regrown ranks that held nothing;
    one launch a rank an iteration (5 at (1, 64, 1500) on the 4 x 3 grid,
    none on a resume of a completed phase); each run bitwise its
    composition by hand, the faulted runs and the straggler's shrink
    bitwise the planned ones; the hinge runs against ``cuda``'s and the
    logistic twin within F32_REDUCTION, ``async-mesh`` within STALENESS
    of ``async``; one window's stream bitwise the tiled mesh run and each
    placed tile the window's slice by digest; and prints the ms an
    iteration by segment, the seconds from a rescale's commit to the
    first segment on the re-formed group and until the regrown ranks hold
    their tiles, the streaming ms an iteration against the static run's,
    each rank's ``place_s``, ``wait_s`` and ``overlap_ratio`` and the
    memory;
13. holds ``flash_attention`` against its plain version at the gemma2-9b
   prefill shape (B=4, H=16, KV=8, S=4608, D=256, bf16) for a local and a
   global layer, at a decode offset, at unaligned bf16 shapes for the other
   head dims (16, 64, 128: causal, non-causal, window + softcap, decode
   offset), at unaligned f32 shapes and with q, k, v bf16 views whose data
   is not 16-byte aligned (bitwise the aligned copies' output), and times
   it at the layer shape beside its bound, its plain version and
   ``scaled_dot_product_attention``.
   bf16 takes the wgmma kernel, f32 the CUDA-core one. A bf16 output must
   be its f32 value correctly rounded (see ``F32_NOISE``), and two
   controls must fail that rule: scores rounded to bf16, and P rounded to
   bf16 before P.V (the textbook tensor-core kernel);
14. runs gemma2-9b at full width, cut to 4 layers, in f32, on 4608-token
    prompts through ``serve`` with the kernel and with the plain version:
    prefill logits and 8 decode steps' logits within 2e-4, and 8 greedy
    tokens identical;
15. serves 4 requests of 4608 prompt tokens for 32 tokens each through
    full-depth bf16 gemma2-9b (``repro_torch.launch.serve.serve``, the
    second main path, with the flash launch count set to 0 just before it):
    42 launches in the prefill and none in the decode, finite logits, and
    prefill time, decode time per token and peak device memory. Then each
    of the 42 layers' attention, on the plain path's activations, is held
    to the rounding rule of 13 (both controls failing it), and the rms gap of
    the kernel path's logits to the plain path's to 1.2x the plain path's
    gap to itself summed in another order;
16. holds ``ssd_scan`` against its plain chunked version at the mamba2-130m
    layer shape (B=16, S=2048, H=24, P=64, G=1, N=128), with Mamba-2's dt
    and A and a slow-decay case, at S = 1000 and at G = 2, in f32
    (the CUDA-core route, rtol = atol = 1e-4) and bf16 (the wgmma route,
    the rounding rule of 13 over max|y|, which four controls must fail: the
    carry dropped, and each f32 operand of the tensor-core products rounded
    once to bf16: W, the state as C . state reads it, and x_j w_j of the
    state update), requires two launches to agree bitwise, prints each
    case's route and the inter-chunk share ||y_inter|| / ||y||, runs x, B
    and C as bf16 views whose data is not 16-byte aligned (bitwise the
    aligned copies' output), and times kernel and plain version beside the
    bound;
17. runs full-depth mamba2-130m in f32 (B=2, 1024 prompt tokens, Mamba-2's
    A_log and dt_bias): the kernel path's prefill logits within 2e-4 of the
    plain path's and of the decode warm-up's last logits (the scan against
    the recurrence), and 8 decode steps' logits, fed random tokens, within
    2e-4 of the scan's at the same positions;
18. serves 16 requests of 2048 prompt tokens for 32 tokens each through
    full-depth bf16 mamba2-130m (``serve``, the third main path, with the
    SSD launch counts set to 0 just before it): 24 launches in the
    prefill, all on the wgmma route, and none in the warm-up or decode,
    finite logits, and prefill time, warm-up time, decode time per token
    and peak device memory. Then each of the 24 layers' SSD, on the plain
    path's activations, is held to the rounding rule of 13, every control
    failing it.

Exits non-zero if any phase fails. The last three lines of standard output
are the card line, a JSON ``kernels`` record and a JSON ``ok`` record.
"""
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B  # noqa: E402
from repro_torch.configs.mamba2_130m import CONFIG as MAMBA2_130M  # noqa: E402
from repro_torch import checkpoint  # noqa: E402
from repro_torch.configs.sodda_svm import SoddaConfig, TABLE1_250K_18K  # noqa: E402
from repro_torch.core import (driver, engine, losses, partition,  # noqa: E402
                               radisa, sodda)
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.plane import (DenseDataPlane,  # noqa: E402
                                    StreamingDataPlane, TiledDataPlane)
from repro_torch.data.synthetic import make_svm_data  # noqa: E402
from repro_torch.distributed import run_elastic, shrink_plane  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as flash_build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sodda_inner as kernel_build  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402
from repro_torch.launch.serve import (make_serve_steps, serve,  # noqa: E402
                                      warm_up)
from repro_torch.models import Model, transformer  # noqa: E402
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import ssm as mssm  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.testing import tolerances as tol  # noqa: E402
from repro_torch.testing.multiprocess import tile_digest  # noqa: E402

ITERS = 20  # outer iterations of each Table-1 run
RECORD_EVERY = 5
SEED = 0

# H100 SXM peaks (NVIDIA data sheet) for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# flash_attention against its plain version: tests/test_kernels.py:201
# holds the Pallas kernel to its oracle at 2e-5 in f32.
FLASH_F32_TOL = 2e-5
# In bf16 a sound kernel rounds its f32 result to the nearest bf16, so each
# output lies within half a bf16 ulp of the plain version run on f32 copies
# of the inputs, give or take the f32 summation noise of either, which is
# held to F32_NOISE x max|v|. Two controls must fail it: scores rounded to
# bf16 before the softmax (as the JAX reference's einsum does), and P
# rounded to bf16 before P.V (as a textbook tensor-core kernel does). On an
# H100 the wgmma kernel's excess was at most 7.837e-07, the bf16-score
# control's at least 6.845e-05 and the P-in-bf16 control's at least
# 3.089e-05 (every bf16 case and all 42 layers of the serving run): the
# limit sits ~5x from the kernel and ~8x from the nearer control.
F32_NOISE = 2.0 ** -18
# the decode-vs-forward tolerance of tests/test_models.py:74
MODEL_TOL = 2e-4
# ssd_scan against its plain version: tests/test_kernels.py:258 holds the
# Pallas kernel to the recurrence at 1e-4 in f32; in bf16 the rule is
# F32_NOISE's, over max|y|.
SSD_F32_TOL = 1e-4
SSD_SHAPE = (16, 2048, 24, 64, 1, 128)  # (B, S, H, P, G, N): a serving layer
SSM_F32_B, SSM_F32_PROMPT, SSM_F32_FED = 2, 1024, 8
# Full-depth f32 mamba2: the plain path against itself at another chunk
# length (the same function summed in another order) moves single logits
# by ~3e-4, past the elementwise 2e-4 rule, so the logits are held by
# their rms gap to that floor; each layer's SSD is held to SSD_F32_TOL.
FLOOR_FACTOR = 2.0
# 2048: the context of the Mamba-2 paper's language-model runs
SSM_SERVE_B, SSM_SERVE_PROMPT, SSM_SERVE_GEN = 16, 2048, 32
SERVE_B, SERVE_PROMPT, SERVE_GEN = 4, 4608, 32  # 4608 = 36 x 128 > 4096
CUT_DEPTH_LAYERS, CUT_DEPTH_B, CUT_DEPTH_GEN = 4, 2, 8
# Full depth in bf16: the rms gap of the kernel path's last-token logits to
# the plain path's, against the plain path's gap to itself summed in
# 256-key chunks (the summation-order floor of 42 bf16 layers).
RMS_GAP_FACTOR = 1.2

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


# sodda_inner's cases: the Table-1 widths m_tilde = 1200 (SMALL and the
# 250k x 18k instance), 1400 (MEDIUM) and 1800 (LARGE); an unaligned mt, a
# row pitch that is no multiple of 16 bytes (the cp.async copy), L = 1, an
# mt above the register buckets (wbar in shared memory) and the largest mt
# the one-block-per-chain kernel of the first slice took at L = 3.
KERNEL_SHAPES = ((15, 64, 1200), (15, 64, 1400), (15, 64, 1800), (2, 8, 100),
                 (3, 5, 301), (3, 1, 1200), (3, 16, 2100), (2, 3, 19344))
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 10


def graph_ms(fn):
    """Device time of one fn() by a CUDA graph of GRAPH_LAUNCHES calls,
    replayed GRAPH_REPLAYS times between CUDA events: the kernels alone,
    without the host's time per call."""
    for _ in range(3):
        fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (GRAPH_REPLAYS * GRAPH_LAUNCHES)


def host_us(fn, reps=200):
    """Host time of one fn() call in microseconds (no synchronisation
    inside the loop)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * spent / reps


def phase_kernel():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    for (B, L, mt) in KERNEL_SHAPES:
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
                f"max|kernel-plain| = {err:.3e}; bucket "
                f"{kernel_build.bucket(mt)}, {kernel_build.ring_slots(L, mt)}"
                f" ring slots, {kernel_build.row_copy(mt, args[1].data_ptr())}"
                f" row copy, {kernel_build.shared_memory_bytes(L, mt)} bytes "
                "of shared memory")

    B, L, mt = 15, 64, 1200  # Table-1: P*Q chains of L rows, m_tilde wide
    args = kernel_inputs(B, L, mt, gen)

    def launch():
        return ops.sodda_inner(*args, 0.01, "hinge", force="cuda")

    ms = graph_ms(launch)
    wrapper_ms = cuda_ms(launch, reps=200)
    wrapper_host_us = host_us(launch)
    plain_ms = cuda_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                               force="ref"), reps=10)
    bound_ms, bound_by = kernel_bound_ms(B, L, mt)
    log(f"kernel sodda_inner (15, 64, 1200) hinge: {ms:.5f} ms (a CUDA graph "
        f"of {GRAPH_LAUNCHES} launches replayed {GRAPH_REPLAYS} times: the "
        f"kernel), bound {bound_ms:.5f} ms ({bound_by}), kernel/bound "
        f"{ms / bound_ms:.1f}x; the wrapper takes {wrapper_host_us:.1f} us "
        f"of host time a call; plain {plain_ms:.4f} ms")
    log(f"kernel sodda_inner (15, 64, 1200) hinge, CUDA events around "
        f"back-to-back wrapper calls (the earlier method): {wrapper_ms:.5f} "
        "ms")
    for mt_wide in (1400, 1800):
        wide = kernel_inputs(B, L, mt_wide, gen)
        wide_ms = graph_ms(lambda: ops.sodda_inner(*wide, 0.01, "hinge",
                                                   force="cuda"))
        log(f"kernel sodda_inner (15, 64, {mt_wide}) hinge: {wide_ms:.5f} ms "
            f"(CUDA graph), bound {kernel_bound_ms(B, L, mt_wide)[0]:.5f} ms")
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
    split = consume_update_split(cfg, X, y, w, mu, smp, gamma)
    log("breakdown consume_update split: "
        + ", ".join(f"{name} {ms:.4f} ms" for name, ms in split.items())
        + f"; sum {sum(split.values()):.4f} ms")
    return parts


def consume_update_split(cfg, X, y, w, mu, smp, gamma):
    """Device time of the three parts of ``sodda.consume_update`` with the
    kernel (CUDA events, each part alone): the gather of the working sets,
    the kernel, and the conflict-free concatenation. The parts repeat that
    function's lines; ``core/sodda.py`` is not changed for it."""
    P, Q, n, m, L, mt = cfg.P, cfg.Q, cfg.n, cfg.m, cfg.L, cfg.m_tilde
    dev = X.device
    p_ar = torch.arange(P, device=dev)
    q_ar = torch.arange(Q, device=dev)

    def gather():
        k = smp.pi.T
        rows = p_ar[:, None, None] * n + smp.J
        col0 = partition.block_col_start(q_ar[None, :], k, m, mt)
        cols = col0[..., None] + torch.arange(mt, device=dev)
        Xl = X[rows[..., :, None], cols[..., None, :]]
        wb = w.view(Q, P, mt)
        return (wb[q_ar[None, :], k].reshape(P * Q, mt),
                Xl.reshape(P * Q, L, mt), y[rows].reshape(P * Q, L),
                mu.view(Q, P, mt)[q_ar[None, :], k].reshape(P * Q, mt))

    w0, Xl, yl, mu_blk = gather()
    wL = ops.sodda_inner(w0, Xl, yl, mu_blk, gamma, cfg.loss).view(P, Q, mt)

    def concat():
        new_wb = w.view(Q, P, mt).clone()
        new_wb[q_ar.repeat_interleave(P), smp.pi.reshape(-1)] = (
            wL.transpose(0, 1).reshape(Q * P, mt))
        return new_wb.view(cfg.M)

    check(torch.equal(concat(), sodda.consume_update(X, y, w, mu, smp, gamma,
                                                     cfg, True)),
          "consume_update split: the parts do not give consume_update")
    return {"gather": cuda_ms(gather, reps=10),
            "kernel": cuda_ms(lambda: ops.sodda_inner(w0, Xl, yl, mu_blk,
                                                      gamma, cfg.loss),
                              reps=10),
            "concatenation": cuda_ms(concat, reps=10)}


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


# ---------------------------------------------------------------------------
# The paper's baseline and the stale-by-one backend over the tiled plane
# ---------------------------------------------------------------------------
RADISA_SHAPE = (15, 64, 6000)  # radisa-avg at Table-1: P*Q chains, m wide


def plain_run(cfg, X, y, step):
    """``driver.run``'s loop and ticks around ``step(state) -> state``, for
    a plain-version step no backend runs."""
    state = sodda.init_state(SEED, cfg.M, X.device)
    hist = []
    for length in driver._chunk_lengths(ITERS, RECORD_EVERY):
        hist.append(losses.objective(cfg.loss, X, y, state.w))
        for _ in range(length):
            state = step(state)
    hist.append(losses.objective(cfg.loss, X, y, state.w))
    return state, list(zip(driver.record_ticks(ITERS, RECORD_EVERY),
                           torch.stack(hist).tolist()))


def timed_run(data, cfg, backend, iters=ITERS, record_every=RECORD_EVERY,
              **options):
    """``driver.run`` between synchronisations: (state, history, ms per
    iteration)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = driver.run(SEED, data, cfg, iters, backend,
                             record_every=record_every, **options)
    torch.cuda.synchronize()
    return state, hist, 1e3 * (time.perf_counter() - t0) / iters


def inner_loop_fused(loss, w0, Xl, yl, mu, gamma):
    """``kref.sodda_inner_ref`` with each step's update rounded as fused
    multiply-adds (``addcmul``, ``add(alpha=)``), as the kernel rounds it:
    the plain version a hinge trajectory is held to."""
    wbar = w0
    for i in range(Xl.shape[-2]):
        x, yy = Xl[..., i, :], yl[..., i]
        c = (losses.loss_deriv(loss, (x * wbar).sum(-1), yy)
             - losses.loss_deriv(loss, (x * w0).sum(-1), yy))
        wbar = torch.add(wbar, torch.addcmul(mu, c[..., None], x),
                         alpha=-gamma)
    return wbar


@contextlib.contextmanager
def radisa_inner_as(fn):
    """Route ``radisa_avg_step``'s plain chains to fn inside the block."""
    orig = radisa.inner_loop
    radisa.inner_loop = fn
    try:
        yield
    finally:
        radisa.inner_loop = orig


def kink_sides(X, y, w_a, w_b):
    """Rows of X on different sides of the hinge kink y x.w = 1 at w_a and
    at w_b."""
    return int(((y * (X @ w_a) < 1) != (y * (X @ w_b) < 1)).sum())


def phase_tiled_plane(cfg):
    """The tiled plane materialised on the card: its time, its peak over X,
    and one tile and one label block against the same blocks regenerated
    alone. Also logs whether ``uniform_`` writing into a strided view of X
    gives the tile's bits (the plane copies from a contiguous temporary,
    so its bits do not depend on the answer)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plane = TiledDataPlane(SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    t0 = time.perf_counter()
    X, y = plane.materialize_for("radisa-avg")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x_bytes = X.numel() * X.element_size()
    peak = (torch.cuda.max_memory_allocated() - base) / x_bytes
    log(f"tiled plane {cfg.N} x {cfg.M} on a ({cfg.P}, {cfg.Q}) grid "
        f"materialised on the card in {seconds:.3f} s; X = "
        f"{x_bytes / 1e9:.3f} GB, a tile {plane.tile_nbytes / 1e9:.3f} GB; "
        f"peak {peak:.4f} x X")
    check(peak <= 1.1, f"tiled plane: peak {peak:.4f} x X > 1.1")
    n, m = plane.n, plane.m
    p, q = cfg.P - 2, cfg.Q - 2
    view = X[p * n:(p + 1) * n, q * m:(q + 1) * m]
    check(torch.equal(view, plane.x_tile(p, q)),
          f"tiled plane: tile ({p}, {q}) differs from the tile alone")
    check(torch.equal(y[(p + 1) * n:(p + 2) * n], plane.y_block(p + 1)),
          f"tiled plane: label block {p + 1} differs from the block alone")
    check(bool(torch.isfinite(X[:1000]).all()), "non-finite data")
    gen = partition.seeded_generator(X.device, SEED, synthetic._X_STREAM, p,
                                     q)
    view.uniform_(-1.0, 1.0, generator=gen)
    view.mul_(float(synthetic.SVM_UNIT_VARIANCE_SCALE))
    same = torch.equal(view, plane.x_tile(p, q))
    view.copy_(plane.x_tile(p, q))
    log(f"tiled plane: tile ({p}, {q}) and label block {p + 1} bitwise "
        "equal to the blocks regenerated alone; uniform_ into the strided "
        f"view of X gives the tile's bits: {same}")
    return X, y


def phase_kernel_at(shape, seed):
    """sodda_inner at one launch shape of a path, for all three losses:
    bitwise across launches, within tolerance of the plain version, and
    timed by a CUDA graph beside its bound. Returns the hinge time in ms."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, L, mt = shape
    for loss in ("hinge", "logistic", "squared"):
        args = kernel_inputs(B, L, mt, gen)
        gamma = KERNEL_GAMMA[loss]
        a = ops.sodda_inner(*args, gamma, loss, force="cuda")
        b = ops.sodda_inner(*args, gamma, loss, force="cuda")
        want = ops.sodda_inner(*args, gamma, loss, force="ref")
        torch.cuda.synchronize()
        check(torch.equal(a, b),
              f"sodda_inner {loss} {shape}: two launches differ")
        check(bool(torch.isfinite(a).all()),
              f"sodda_inner {loss} {shape}: non-finite output")
        torch.testing.assert_close(a, want, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        log(f"kernel {loss:8s} {shape}: bitwise across launches, "
            f"max|kernel-plain| = {float((a - want).abs().max()):.3e}; "
            f"bucket {kernel_build.bucket(mt)}, "
            f"{kernel_build.ring_slots(L, mt)} ring slots, "
            f"{kernel_build.row_copy(mt, args[1].data_ptr())} row copy, "
            f"{kernel_build.shared_memory_bytes(L, mt)} bytes of shared "
            "memory")
    args = kernel_inputs(B, L, mt, gen)
    ms = graph_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                          force="cuda"))
    plain_ms = cuda_ms(lambda: ops.sodda_inner(*args, 0.01, "hinge",
                                               force="ref"), reps=5)
    bound_ms, bound_by = kernel_bound_ms(B, L, mt)
    log(f"kernel sodda_inner {shape} hinge: {ms:.5f} ms (CUDA "
        f"graph), bound {bound_ms:.5f} ms ({bound_by}), kernel/bound "
        f"{ms / bound_ms:.1f}x; plain {plain_ms:.4f} ms")
    return ms


def phase_radisa_kernel():
    """sodda_inner at radisa-avg's Table-1 launch."""
    phase_kernel_at(RADISA_SHAPE, SEED + 1)


def phase_radisa_async(cfg, X, y):
    """radisa-avg and async through ``driver.run`` on the materialised
    tiled plane (wrapped as a dense plane, so it is not generated again):
    launches, agreement with the plain path and with ``cuda``, descent,
    and the paper's SODDA vs RADiSA-avg comparison (a finding, no gate)."""
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    for backend in ("radisa-avg", "async", "cuda"):  # warm-up
        driver.run(SEED, data, cfg, 2, backend, record_every=2)

    ops.sodda_inner.launches = 0  # the radisa-avg path starts here
    st_r, h_r, ms_r = timed_run(data, cfg, "radisa-avg")
    launches = ops.sodda_inner.launches  # ... and ends here
    log(f"radisa-avg: {ms_r:.3f} ms/iteration over {ITERS} iterations "
        f"(objective every {RECORD_EVERY}); {launches} launches; history "
        f"{[(t, round(f, 6)) for t, f in h_r]}")
    check(launches == ITERS,
          f"radisa-avg launched sodda_inner {launches} times in {ITERS} "
          "iterations")
    check(all(math.isfinite(f) for _, f in h_r), f"non-finite {h_r}")
    check(h_r[-1][1] < h_r[0][1], f"radisa-avg did not descend: {h_r}")
    # Hinge. (1) Every iteration of that trajectory, stepped from the same
    # state by the kernel and by the plain version, to F32_REDUCTION in
    # full. (2) The trajectory, at the objective level, to F32_REDUCTION
    # against the plain path whose chains round their update as the kernel
    # does (fused multiply-adds). Hinge's subgradient is a step at
    # y*z = 1, so that rounding alone moves rows of X across the kink over
    # 20 iterations; the plain path with unfused updates departs from both,
    # which is printed beside it, not gated.
    state, worst = sodda.init_state(SEED, cfg.M, X.device), 0.0
    for t in range(1, ITERS + 1):
        k = radisa.radisa_avg_step(state, X, y, cfg, use_kernel=True)
        p = radisa.radisa_avg_step(state, X, y, cfg, use_kernel=False)
        tol.assert_trajectories_close([p.w.cpu().numpy()],
                                      [k.w.cpu().numpy()], tol.F32_REDUCTION,
                                      f"radisa-avg hinge step {t}")
        tol.assert_objectives_close(
            float(losses.objective(cfg.loss, X, y, p.w)),
            float(losses.objective(cfg.loss, X, y, k.w)), tol.F32_REDUCTION,
            f"radisa-avg hinge step {t}")
        worst = max(worst, float((k.w - p.w).abs().max()))
        state = k
    check(torch.equal(state.w, st_r.w),
          "radisa-avg: stepping by hand is not driver.run's trajectory")
    log(f"radisa-avg hinge: each of the {ITERS} iterations, kernel and plain "
        "from the same state, within F32_REDUCTION (w and objective); "
        f"max|w_kernel - w_plain| = {worst:.3e}")
    with radisa_inner_as(inner_loop_fused):
        st_f, h_fused = plain_run(cfg, X, y, lambda s: radisa.radisa_avg_step(
            s, X, y, cfg, use_kernel=False))
    for (t, f_f), (_, f_k) in zip(h_fused, h_r):
        tol.assert_objectives_close(f_f, f_k, tol.F32_REDUCTION,
                                    f"radisa-avg hinge t={t} (fused plain)")
    st_p, h_plain = plain_run(cfg, X, y, lambda s: radisa.radisa_avg_step(
        s, X, y, cfg, use_kernel=False))

    def gaps(a, b):
        floor = tol.F32_REDUCTION.obj_floor
        return [f"{abs(fa - fb) / max(abs(fa), floor):.2e}"
                for (_, fa), (_, fb) in zip(a, b)]

    log(f"radisa-avg hinge trajectory: within F32_REDUCTION of the plain "
        f"path with fused multiply-adds in the chains at every tick, "
        f"relative gap {gaps(h_fused, h_r)}; the unfused plain path "
        f"(a finding, not gated) {[round(f, 6) for _, f in h_plain]}, "
        f"relative gap to the kernel {gaps(h_plain, h_r)}, to the fused "
        f"plain path {gaps(h_plain, h_fused)} (F32_REDUCTION allows "
        f"{tol.F32_REDUCTION.obj_rel:.0e}); rows of X on other sides of the "
        f"hinge kink at the final iterates: kernel vs unfused plain "
        f"{kink_sides(X, y, st_r.w, st_p.w)}, fused vs unfused plain "
        f"{kink_sides(X, y, st_f.w, st_p.w)}, kernel vs fused plain "
        f"{kink_sides(X, y, st_r.w, st_f.w)} of {cfg.N}")
    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    st_l, h_l = driver.run(SEED, data, lcfg, ITERS, "radisa-avg",
                           record_every=RECORD_EVERY)
    st_lp, h_lp = plain_run(lcfg, X, y, lambda s: radisa.radisa_avg_step(
        s, X, y, lcfg, use_kernel=False))
    tol.assert_trajectories_close([st_lp.w.cpu().numpy()],
                                  [st_l.w.cpu().numpy()], tol.F32_REDUCTION,
                                  "radisa-avg logistic final w")
    for (t, f_p), (_, f_k) in zip(h_lp, h_l):
        tol.assert_objectives_close(f_p, f_k, tol.F32_REDUCTION,
                                    f"radisa-avg logistic t={t}")
    check(h_l[-1][1] < h_l[0][1], f"radisa-avg logistic: no descent {h_l}")
    log("radisa-avg logistic twin: kernel and plain trajectories within "
        f"F32_REDUCTION in full, F {h_l[0][1]:.6f} -> {h_l[-1][1]:.6f}")

    sync = engine.make_bundle(cfg, "cuda")
    stale0 = engine.make_bundle(cfg, "async", staleness=0)
    state = sodda.init_state(SEED, cfg.M, X.device)
    carry = stale0.init_carry(state, X, y)
    for t in range(1, ITERS + 1):
        state, carry = sync.step(state, X, y), stale0.step(carry, X, y)
        check(torch.equal(state.w, carry.w),
              f"async staleness 0 differs from cuda at iteration {t}")
    st_c, h_c, ms_c = timed_run(data, cfg, "cuda")
    st_0, h_0, _ = timed_run(data, cfg, "async", staleness=0)
    check(h_0 == h_c and torch.equal(st_0.w, st_c.w),
          f"async staleness 0 history {h_0} is not cuda's {h_c}")
    log(f"async staleness 0: bitwise cuda's trajectory, each of {ITERS} "
        "iterates and the history")
    ops.sodda_inner.launches = 0  # the async path starts here
    _, h_a, ms_a = timed_run(data, cfg, "async")
    launches_a = ops.sodda_inner.launches  # ... and ends here
    log(f"async staleness 1: {ms_a:.3f} ms/iteration; {launches_a} "
        f"launches; history {[(t, round(f, 6)) for t, f in h_a]}")
    check(launches_a == ITERS,
          f"async launched sodda_inner {launches_a} times in {ITERS} "
          "iterations")
    check(h_a[-1][1] < h_a[0][1], f"async did not descend: {h_a}")
    tol.assert_objectives_close(h_c[-1][1], h_a[-1][1], tol.STALENESS,
                                "async staleness 1 vs cuda")
    log(f"async staleness 1: final objective {h_a[-1][1]:.6f} within "
        f"STALENESS of cuda's {h_c[-1][1]:.6f}")

    # the paper's comparison: every iteration's objective, by cost and time
    _, h_s1 = driver.run(SEED, data, cfg, ITERS, "cuda")
    _, h_r1 = driver.run(SEED, data, cfg, ITERS, "radisa-avg")
    f_s, f_r = sodda.iteration_flops(cfg), radisa.radisa_avg_iteration_flops(
        cfg)
    it_cost = int(ITERS * f_s / f_r)
    it_wall = min(ITERS, int(ITERS * ms_c / ms_r))
    log(f"paper comparison (a finding, no gate): cuda (SODDA) "
        f"{ms_c:.3f} ms/iteration, radisa-avg {ms_r:.3f}; gradient "
        f"coordinates an iteration {f_s:.4e} vs {f_r:.4e} ({f_r / f_s:.4f}x)")
    log(f"paper comparison histories: sodda "
        f"{[round(f, 6) for _, f in h_s1]}; radisa-avg "
        f"{[round(f, 6) for _, f in h_r1]}")
    log(f"paper comparison at SODDA's {ITERS} iterations of cost: sodda "
        f"F = {h_s1[ITERS][1]:.6f}; radisa-avg after {it_cost} iterations "
        f"(equal gradient coordinates) F = {h_r1[it_cost][1]:.6f}, after "
        f"{it_wall} (equal wall time) F = {h_r1[it_wall][1]:.6f}")


# ---------------------------------------------------------------------------
# Checkpoints, resumable runs, the streaming plane and elastic rescale
# ---------------------------------------------------------------------------
RESUME_SEGMENT = 10  # phase_resumable: 2 segments of the 20 iterations
STREAM_SEGMENT = 5  # phase_streaming: 4 windows in 20 iterations
ELASTIC_P = 4  # phase_elastic: the grid after one partition is lost
ELASTIC_SHAPE = (ELASTIC_P * TABLE1_250K_18K.Q, TABLE1_250K_18K.L,
                 TABLE1_250K_18K.M // (ELASTIC_P * TABLE1_250K_18K.Q))
CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_checkpoints")
# the reference's resume-guard stamp (src/repro/core/driver.py,
# run_resumable's `want`), read from the manifest without the port's code
STAMP_KEYS = ("history", "backend", "record_every", "segment_iters",
              "options", "data", "streaming", "key")


class Killed(RuntimeError):
    """An injected kill."""


def kill_at(step):
    def seam(done):
        if done == step:
            raise Killed(f"injected kill at iteration {done}")
    return seam


def ckpt_dir(name):
    path = os.path.join(CKPT_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def launched(fn, *args, **kwargs):
    """fn(*args, **kwargs) with the sodda_inner launch count set to 0 just
    before it: (result, launches, seconds). The run's seconds start at its
    first segment (after a synchronisation there), so they leave out the
    resume guard's data fingerprint, and end synchronised."""
    t_first = []

    def first_segment(done):
        if not t_first:
            torch.cuda.synchronize()
            t_first.append(time.perf_counter())
        if chained is not None:
            chained(done)

    chained = kwargs.pop("on_segment_start", None)
    if fn in (driver.run_resumable, run_elastic):
        kwargs["on_segment_start"] = first_segment
    torch.cuda.synchronize()
    ops.sodda_inner.launches = 0  # this run starts here
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    finally:
        launches = ops.sodda_inner.launches  # ... and ends here
    torch.cuda.synchronize()
    return out, launches, time.perf_counter() - (t_first or [t0])[0]


def same_run(a, b, what):
    (s_a, h_a), (s_b, h_b) = a, b
    check(h_a == h_b, f"{what}: histories differ: {h_a} vs {h_b}")
    check(torch.equal(s_a.w, s_b.w) and s_a.t == s_b.t,
          f"{what}: final iterates differ")


def read_manifest_by_hand(step_dir):
    """A checkpoint read back with the reference's manifest layout, by
    json, numpy and zlib alone: the leaf names, files, dtypes, shapes and
    crc of every leaf, and the guard stamp. Returns the leaves."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        man = json.load(f)
    check(os.path.exists(os.path.join(step_dir, "_COMMITTED")),
          f"{step_dir}: no _COMMITTED marker")
    leaves = {}
    for name, meta in man["leaves"].items():
        check(meta["file"] == name + ".0.npy",
              f"leaf {name}: file {meta['file']}")
        arr = np.load(os.path.join(step_dir, meta["file"]))
        check(str(arr.dtype) == meta["dtype"]
              and list(arr.shape) == meta["shape"]
              and zlib.crc32(arr.tobytes()) & 0xFFFFFFFF == meta["crc"],
              f"leaf {name}: dtype/shape/crc do not match the manifest")
        leaves[name] = arr
    check(set(STAMP_KEYS) <= set(man["extra"]),
          f"stamp {sorted(man['extra'])} lacks {STAMP_KEYS}")
    return man, leaves


def phase_resumable(cfg, X, y):
    """run_resumable at Table-1 over the tiled plane's data: bitwise
    driver.run back to back; killed after a boundary and at a mid-segment
    commit, then resumed, bitwise (cuda; async at staleness 1 and
    radisa-avg after a boundary); no recomputation on a resume of a
    completed run; replay_segment; the checkpoint read back by hand in the
    reference's layout; and the times of the driver, a save and the data
    fingerprint."""
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    kw = dict(segment_iters=RESUME_SEGMENT, record_every=RECORD_EVERY)
    one, n_one, s_one = launched(driver.run, SEED, data, cfg, ITERS, "cuda",
                                 record_every=RECORD_EVERY)
    d_full = ckpt_dir("resumable-cuda")
    full, n_full, s_full = launched(driver.run_resumable, SEED, data, cfg,
                                    ITERS, "cuda", checkpoint_dir=d_full, **kw)
    check(n_one == n_full == ITERS,
          f"launches: driver.run {n_one}, run_resumable {n_full}")
    same_run(full, one, "run_resumable vs driver.run (cuda)")
    ms_one, ms_full = 1e3 * s_one / ITERS, 1e3 * s_full / ITERS
    log(f"resumable: run_resumable (cuda, {ITERS // RESUME_SEGMENT} segments"
        f" of {RESUME_SEGMENT}) bitwise driver.run in w and history; "
        f"{ms_full:.3f} ms/iteration against driver.run's {ms_one:.3f} "
        f"({100 * (ms_full / ms_one - 1):+.2f}%); {n_full} launches each")

    def kill_and_resume(backend, name, killed_kw, resumed_kw, done_at,
                        want, **options):
        d = ckpt_dir(name)
        ops.sodda_inner.launches = 0
        try:
            driver.run_resumable(SEED, data, cfg, ITERS, backend,
                                 checkpoint_dir=d, **kw, **killed_kw,
                                 **options)
            fail(f"{name}: the injected kill did not fire")
        except Killed:
            pass
        check(ops.sodda_inner.launches == done_at,
              f"{name}: the killed run launched {ops.sodda_inner.launches}"
              f" times in {done_at} iterations")
        check(checkpoint.latest_step(d) == done_at,
              f"{name}: latest commit {checkpoint.committed_steps(d)}, "
              f"expected {done_at}")
        got, n, _ = launched(driver.run_resumable, SEED, data, cfg, ITERS,
                             backend, checkpoint_dir=d, **kw, **resumed_kw,
                             **options)
        check(n == ITERS - done_at,
              f"{name}: resume launched {n}, expected {ITERS - done_at}")
        same_run(got, want, f"{name}: resumed vs uninterrupted")
        log(f"resumable: {name}: killed at {done_at}, resumed with {n} "
            "launches, bitwise the uninterrupted run")
        return d

    kill_and_resume("cuda", "cuda-boundary",
                    dict(on_segment=kill_at(RESUME_SEGMENT)), {},
                    RESUME_SEGMENT, full)
    mid = RESUME_SEGMENT + RECORD_EVERY
    d_mid = kill_and_resume("cuda", "cuda-commit",
                            dict(commit_every=RECORD_EVERY,
                                 on_commit=kill_at(mid)),
                            dict(commit_every=RECORD_EVERY), mid, full)
    for backend, options in (("async", {"staleness": 1}), ("radisa-avg", {})):
        ref_run, n, _ = launched(driver.run_resumable, SEED, data, cfg,
                                 ITERS, backend,
                                 checkpoint_dir=ckpt_dir(backend + "-full"),
                                 **kw, **options)
        check(n == ITERS, f"{backend}: {n} launches in {ITERS} iterations")
        kill_and_resume(backend, backend + "-boundary",
                        dict(on_segment=kill_at(RESUME_SEGMENT)), {},
                        RESUME_SEGMENT, ref_run, **options)

    again, n, _ = launched(driver.run_resumable, SEED, data, cfg, ITERS,
                           "cuda", checkpoint_dir=d_full, **kw)
    check(n == 0, f"resume of a completed run launched {n} times")
    same_run(again, full, "resume of a completed run")
    rep, n, _ = launched(driver.replay_segment, SEED, data, cfg, "cuda",
                         checkpoint_dir=d_mid, **kw)
    check(rep.get("match") is True and n == rep["end"] - rep["start"],
          f"replay_segment: {rep}, {n} launches")
    log(f"resumable: a resume of the completed run launched 0 times; "
        f"replay_segment {rep} with {n} launches")

    man, leaves = read_manifest_by_hand(
        os.path.join(d_full, f"step_{ITERS:010d}"))
    check(list(man["leaves"]) == [".w", ".t", ".key"]
          and [str(leaves[k].dtype) for k in (".w", ".t", ".key")]
          == ["float32", "int32", "uint32"],
          f"leaves {[(k, v['dtype']) for k, v in man['leaves'].items()]}")
    check(leaves[".key"].tolist() == [0, SEED] and int(leaves[".t"]) ==
          ITERS + 1 and np.array_equal(leaves[".w"],
                                       full[0].w.cpu().numpy()),
          "the checkpoint does not hold the run's final state")
    check(man["extra"]["backend"] == "cuda"
          and man["extra"]["key"] == [0, SEED],
          f"stamp {man['extra']['backend']!r}, key {man['extra']['key']}")
    _, async_leaves = read_manifest_by_hand(os.path.join(
        CKPT_ROOT, "async-full", f"step_{ITERS:010d}"))
    check(list(async_leaves) == [".w", ".t", ".key", ".mu"],
          f"async leaves {list(async_leaves)}")
    log("resumable: the checkpoints read back by hand in the reference's "
        "layout: leaves .w float32, .t int32, .key uint32 [0, seed] (and "
        ".mu for async), files <leaf>.0.npy, crc and the guard stamp "
        f"{STAMP_KEYS} all as the reference writes them")

    record = sodda.carry_record(full[0])
    save_s = []
    for k in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckpt_dir("save"), ITERS + k,
                                   sodda.carry_record(full[0]),
                                   extra={"history": full[1]})
        save_s.append(time.perf_counter() - t0)
    fp_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        driver._data_fingerprint(data)
        fp_s.append(time.perf_counter() - t0)
    log(f"resumable: a checkpoint save ({record.w.nbytes / 1e3:.1f} KB of w,"
        f" the iterate copied from the card) {1e3 * min(save_s):.3f} ms "
        f"(min of 5; mean {1e3 * sum(save_s) / 5:.3f}); _data_fingerprint "
        f"(a {data.tile_nbytes / 1e9:.3f} GB tile to the host, hashed) "
        f"{fp_s[0]:.3f} / {fp_s[1]:.3f} s")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def threadless_stream_run(plane, cfg, iters, segment_iters):
    """The streaming run as a loop that materialises each window on the
    calling thread's stream, no prefetcher: what the driver's prefetched
    run must give bitwise."""
    bundle = engine.make_bundle(cfg, "cuda")
    carry, hist = sodda.init_state(SEED, cfg.M, plane.device), []
    for done in range(0, iters, segment_iters):
        Xw, yw = plane.at_epoch(done // segment_iters).materialize()
        for it in range(done, min(done + segment_iters, iters)):
            if it % RECORD_EVERY == 0:
                hist.append(losses.objective(cfg.loss, Xw, yw, carry.w))
            carry = bundle.step(carry, Xw, yw)
    hist.append(losses.objective(cfg.loss, Xw, yw, carry.w))
    return carry, list(zip(driver.record_ticks(iters, RECORD_EVERY),
                           torch.stack(hist).tolist()))


def stream_plane(cfg):
    """The streaming Table-1 plane with no tile cache."""
    return StreamingDataPlane(SEED, cfg.N, cfg.M, cfg.P, cfg.Q,
                              resident_tile_budget=0)


def phase_streaming_anchor(cfg, X, y):
    """The streaming plane against the tiled plane's X: epoch 0 bitwise,
    a one-segment streaming run bitwise the tiled run, and the static cuda
    run's ms an iteration (returned)."""
    stream = stream_plane(cfg)
    Xs, ys = stream.materialize_for("cuda")
    check(torch.equal(Xs, X) and torch.equal(ys, y),
          "streaming epoch 0 is not the tiled plane's data")
    del Xs, ys
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    kw = dict(segment_iters=STREAM_SEGMENT, record_every=RECORD_EVERY)
    one_tiled = driver.run(SEED, data, cfg, STREAM_SEGMENT, "cuda",
                           record_every=RECORD_EVERY)
    one_stream = driver.run_resumable(SEED, stream, cfg, STREAM_SEGMENT,
                                      "cuda", checkpoint_dir=ckpt_dir("one"),
                                      **kw)
    same_run(one_stream, one_tiled, "one-segment streaming vs tiled run")
    (_, _), n_static, s_static = launched(driver.run, SEED, data, cfg, ITERS,
                                          "cuda", record_every=RECORD_EVERY)
    ms_static = 1e3 * s_static / ITERS
    log(f"streaming: epoch 0 bitwise the tiled plane's X and y; a "
        f"one-segment streaming run bitwise the tiled run; static cuda "
        f"{ms_static:.3f} ms/iteration ({n_static} launches)")
    return ms_static


def phase_streaming(cfg, ms_static):
    """The streaming Table-1 plane (no tile cache, a window a segment),
    with no X resident beside it: prefetched runs at depth 1 and 2, and a
    run of the plane and the driver at their defaults (tile cache on),
    bitwise the threadless loop; a kill and resume bitwise; ms an iteration
    against the static cuda run's, the prefetcher's accounting and the peak
    memory over X (at most 2.2 x X at depth 1)."""
    stream = stream_plane(cfg)
    kw = dict(segment_iters=STREAM_SEGMENT, record_every=RECORD_EVERY)
    x_bytes = 4 * cfg.N * cfg.M
    plain = threadless_stream_run(stream, cfg, ITERS, STREAM_SEGMENT)
    runs = {}
    # depth 1 and 2 without the tile cache, then the plane and the driver
    # at their defaults (the cache's budget, depth 1)
    cases = [("depth 1", stream, {"prefetch_depth": 1}),
             ("depth 2", stream, {"prefetch_depth": 2}),
             ("defaults", StreamingDataPlane(SEED, cfg.N, cfg.M, cfg.P,
                                             cfg.Q), {})]
    for name, plane, opts in cases:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stats = {}
        got, n, secs = launched(driver.run_resumable, SEED, plane, cfg,
                                ITERS, "cuda",
                                checkpoint_dir=ckpt_dir(name.replace(" ", "")),
                                stream_stats=stats, **opts, **kw)
        peak = (torch.cuda.max_memory_allocated() - base) / x_bytes
        check(n == ITERS, f"streaming {name}: {n} launches")
        same_run(got, plain, f"streaming {name} vs threadless loop")
        runs[name] = got
        log(f"streaming {name}: bitwise the threadless loop; "
            f"{1e3 * secs / ITERS:.3f} ms/iteration against static "
            f"{ms_static:.3f}; {n} launches; place_s "
            f"{stats['place_s']:.4f}, wait_s {stats['wait_s']:.4f}, "
            f"overlap_ratio {stats['overlap_ratio']:.4f}, consumed "
            f"{stats['consumed']}, cold_misses {stats['cold_misses']}, "
            f"queue_high_water {stats['queue_high_water']}; tile cache "
            f"{stats['cache']} of budget {plane.resident_tile_budget}; peak "
            f"{peak:.4f} x X; history "
            f"{[(t, round(f, 6)) for t, f in got[1]]}")
        if name != "depth 2":
            check(peak <= 2.2, f"streaming {name}: peak {peak:.4f} x X > 2.2")
        del plane
    check(runs["depth 1"][1][-1][1] < runs["depth 1"][1][0][1],
          "streaming: no descent")

    d = ckpt_dir("stream-kill")
    try:
        driver.run_resumable(SEED, stream, cfg, ITERS, "cuda",
                             checkpoint_dir=d,
                             on_segment=kill_at(2 * STREAM_SEGMENT), **kw)
        fail("streaming: the injected kill did not fire")
    except Killed:
        pass
    got, n, _ = launched(driver.run_resumable, SEED, stream, cfg, ITERS,
                         "cuda", checkpoint_dir=d, **kw)
    check(n == ITERS - 2 * STREAM_SEGMENT, f"streaming resume: {n} launches")
    same_run(got, runs["depth 1"], "streaming killed and resumed")
    log(f"streaming: killed at {2 * STREAM_SEGMENT} (epoch 2 being "
        f"prefetched), resumed with {n} launches, bitwise")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


def phase_elastic(cfg, X, y):
    """run_elastic on cuda at Table-1, P 5 -> 4 at iteration 10: the
    kernel at the shrunk launch first, then the trajectory against the
    same composition by hand (migrate_resumable and run_resumable over
    shrink_plane), bitwise, and descent."""
    ms = phase_kernel_at(ELASTIC_SHAPE, SEED + 2)
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    kw = dict(segment_iters=RESUME_SEGMENT, record_every=RECORD_EVERY)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (st, hist, report), n, secs = launched(
        run_elastic, SEED, data, cfg, ITERS, "cuda",
        checkpoint_dir=ckpt_dir("elastic"),
        lose_partition_at=RESUME_SEGMENT, new_P=ELASTIC_P, **kw)
    above = (torch.cuda.max_memory_allocated() - base) / (4 * cfg.N * cfg.M)
    check(n == ITERS, f"elastic: {n} launches in {ITERS} iterations")
    new_cfg = report["new_cfg"]
    check(new_cfg.P == ELASTIC_P and
          (new_cfg.P * new_cfg.Q, new_cfg.L, new_cfg.m_tilde) ==
          ELASTIC_SHAPE, f"elastic: shrunk to {new_cfg}")
    s1, h1 = driver.run_resumable(SEED, data, cfg, RESUME_SEGMENT, "cuda",
                                  checkpoint_dir=ckpt_dir("hand-1"), **kw)
    survivors = shrink_plane(data, ELASTIC_P)
    d2 = ckpt_dir("hand-2")
    driver.migrate_resumable(SEED, survivors, new_cfg, RESUME_SEGMENT, s1,
                             "cuda", checkpoint_dir=d2, history=h1[:-1],
                             **kw)
    by_hand = driver.run_resumable(SEED, survivors, new_cfg, ITERS, "cuda",
                                   checkpoint_dir=d2, **kw)
    same_run((st, hist), by_hand, "elastic vs by hand")
    f = dict(hist)
    check(f[ITERS] < f[RESUME_SEGMENT] < f[0],
          f"elastic: the objective does not descend: {hist}")
    log(f"elastic: P {cfg.P} -> {ELASTIC_P} at {RESUME_SEGMENT}, kernel "
        f"launches {n} (the last {ITERS - RESUME_SEGMENT} at "
        f"{ELASTIC_SHAPE}, {ms:.5f} ms each by a CUDA graph); bitwise the "
        "composition by hand (migrate_resumable + run_resumable over "
        f"shrink_plane); history {[(t, round(v, 6)) for t, v in hist]}; "
        f"{secs:.3f} s from the first segment (the survivors are a row view "
        f"of X, placed with no copy); peak {above:.4f} x X above X")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


# ---------------------------------------------------------------------------
# The doubly-distributed mesh over torch.distributed: 15 ranks on one card
# ---------------------------------------------------------------------------
MESH_SHAPE = (1, TABLE1_250K_18K.L, TABLE1_250K_18K.m_tilde)  # a chain a rank
MESH_CONSUME_TS = (1, 10)  # consume_local held to consume_update at these t
MESH_TIMEOUT_S = 600
MESH_DEVICE = "cuda:0"  # every rank's device: the one card, shared
NCCL_CFG = SoddaConfig(name="smoke-nccl-1x1", P=1, Q=1, n=20_000, m=1200,
                       L=64, lr0=0.05)
MESH_TRANSPORT = ("gloo process group; every collective on the rank's "
                  "cuda:0 tensors (gloo stages them through host memory "
                  "itself)")


def phase_mesh_refs(cfg, X, y):
    """The single-device runs the mesh is held to, on the tiled plane's X
    (the data every rank's tile is drawn from): cuda's iterate at every
    iteration (stepped by hand, bitwise driver.run) and its history; the
    exchange mu of the iterations consume_local is held at; async at
    staleness 1; and the logistic twin on cuda."""
    data = DenseDataPlane(X, y, grid=(cfg.P, cfg.Q))
    sync = engine.make_bundle(cfg, "cuda")
    state = sodda.init_state(SEED, cfg.M, X.device)
    ws, consume = [state.w.cpu().numpy()], []
    for t in range(1, ITERS + 1):
        if t in MESH_CONSUME_TS:
            _, mu = sodda._issue(cfg, X, y, state.w, t, SEED)
            consume.append((ws[-1], mu.cpu().numpy(), t, True))
        state = sync.step(state, X, y)
        ws.append(state.w.cpu().numpy())
    st_c, h_c = driver.run(SEED, data, cfg, ITERS, "cuda",
                           record_every=RECORD_EVERY)
    check(np.array_equal(st_c.w.cpu().numpy(), ws[-1]),
          "mesh refs: stepping cuda by hand is not driver.run's trajectory")
    st_a, h_a = driver.run(SEED, data, cfg, ITERS, "async",
                           record_every=RECORD_EVERY)
    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    st_l, h_l = driver.run(SEED, data, lcfg, ITERS, "cuda",
                           record_every=RECORD_EVERY)
    return dict(ws=ws, h_c=h_c, consume=consume, h_a=h_a, lcfg=lcfg, h_l=h_l,
                w_l=st_l.w.cpu().numpy())


def mesh_runs(ckpt):
    """The spawn's runs on Table-1, in order: a warm-up, the main path
    (shard_map+cuda), async-mesh at staleness 0 and 1, the int8 wires, the
    delta all-reduce, and run_resumable interrupted at its seam and
    resumed."""
    def run(backend="shard_map+cuda", iters=ITERS, **options):
        return dict(backend=backend, iters=iters, record_every=RECORD_EVERY,
                    seed=SEED, options=options)

    resumable = dict(checkpoint_dir=ckpt, segment_iters=RESUME_SEGMENT)
    return {"warm-up": run(iters=RECORD_EVERY),
            "shard_map+cuda": run(),
            "async-mesh/0": run("async-mesh", staleness=0),
            "async-mesh/1": run("async-mesh", staleness=1),
            "int8": run(compress_z=True, compress_mu=True),
            "delta-psum": run(gather_deltas=False),
            "interrupted": dict(run(), resumable=dict(
                resumable, interrupt_at=RESUME_SEGMENT)),
            "resumed": dict(run(), resumable=resumable)}


def hold_mesh_trajectory(name, h_ref, h, w_ref, w):
    """F32_REDUCTION of a mesh run against its reference at every tick and
    on the final iterate; (held, relative gaps by tick)."""
    floor = tol.F32_REDUCTION.obj_floor
    gaps = [abs(fa - fb) / max(abs(fa), floor)
            for (_, fa), (_, fb) in zip(h_ref, h)]
    scale = max(float(np.abs(w_ref).max()), 1.0)
    w_gap = float(np.abs(w_ref - w).max())
    held = (max(gaps) <= tol.F32_REDUCTION.obj_rel and
            w_gap <= tol.F32_REDUCTION.w_rel * scale)
    log(f"mesh {name}: max relative objective gap "
        f"{max(gaps):.3e} by tick {[f'{g:.2e}' for g in gaps]}, "
        f"max|dw| {w_gap:.3e} (F32_REDUCTION allows "
        f"{tol.F32_REDUCTION.obj_rel:.0e} and "
        f"{tol.F32_REDUCTION.w_rel * scale:.3e}): "
        f"{'held' if held else 'DEPARTS'}")
    return held, gaps


MESH_COLLECTIVES = ("all_reduce", "all_gather_cat")  # the Mesh's methods


def mesh_breakdown_rank(cfg, spec, device):
    """A mesh rank's wall time of each layer of a ``shard_map+cuda``
    iteration, over ITERS iterations of the engine's own bundle from w = 0
    with the objective at every one; the first iteration is left out of the
    means. The mesh's collectives are wrapped to synchronise the device
    before and after each call (every rank runs the same collectives in the
    same order), so the time to a collective is the compute that feeds it
    and the time in it is the collective's; ``after delta`` is the
    scatter of the gathered blocks. Then the time of one all-reduce of n
    f32 over the whole group (200 KB at Table-1). Returns (mean ms by
    layer, that all-reduce's mean ms, the final w gathered to (M,))."""
    import torch.distributed as dist

    from repro_torch.testing import multiprocess as mp

    device = mp._device(device)
    mesh = engine.make_mesh_for(cfg, device)
    X, y = mp._plane(spec, device).materialize_for("shard_map+cuda",
                                                   mesh=mesh, device=device)
    bundle = engine.make_bundle(cfg, "shard_map+cuda", device=device,
                                mesh=mesh)
    totals, clock = {}, {"last": 0.0, "on": False}

    def stamp(name):
        mp._sync(device)
        now = time.perf_counter()
        if clock["on"]:
            totals[name] = totals.get(name, 0.0) + now - clock["last"]
        clock["last"] = now

    def timed(method):
        def call(t, axis, *args, tag=None, **kwargs):
            stamp(f"compute to {tag}")
            out = method(t, axis, *args, tag=tag, **kwargs)
            stamp(f"{tag} {method.__name__} over {axis}")
            return out
        return call

    for name in MESH_COLLECTIVES:
        setattr(mesh, name, timed(getattr(mesh, name)))
    try:
        carry = bundle.init_carry(sodda.init_state(SEED, cfg.M, device), X, y)
        for t in range(1, ITERS + 1):
            clock["on"] = t > 1
            stamp("between iterations")
            carry = bundle.step(carry, X, y)
            stamp("after delta")
            bundle.objective(X, y, carry.w)
            stamp("after objective")
        clock["on"] = False
        w = bundle.finalize(carry).w
    finally:
        for name in MESH_COLLECTIVES:
            delattr(mesh, name)
    means = {k: 1e3 * v / (ITERS - 1) for k, v in totals.items()
             if k != "between iterations"}
    z = torch.ones(cfg.n, device=device)
    for _ in range(3):
        dist.all_reduce(z)
    mp._sync(device)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        dist.all_reduce(z)
    mp._sync(device)
    world_ms = 1e3 * (time.perf_counter() - t0) / ITERS
    return means, world_ms, w.cpu().numpy()


def phase_mesh(cfg, refs):
    """Table-1 on a 5 x 3 grid of 15 ranks sharing the card over gloo, one
    spawn (see the module docstring, 12). Returns the kernel's time at the
    mesh launch (1, 64, 1200) by a CUDA graph."""
    from repro_torch.core import distributed as cdist
    from repro_torch.testing import multiprocess as mp

    ms_b1 = phase_kernel_at(MESH_SHAPE, SEED + 3)
    bound_b1, by_b1 = kernel_bound_ms(*MESH_SHAPE)
    torch.cuda.empty_cache()
    world = cfg.P * cfg.Q
    spec = ("tiled", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    d = ckpt_dir("mesh")
    runs = mesh_runs(d)
    jobs = [(mp.rank_runs, (cfg, spec, list(runs.values()), MESH_DEVICE)),
            (mp.rank_runs, (refs["lcfg"], spec,
                            [runs["shard_map+cuda"]], MESH_DEVICE)),
            (mp.rank_steps, (cfg, spec, "shard_map+cuda", refs["ws"][:-1],
                             list(range(1, ITERS + 1)), SEED, None, None,
                             MESH_DEVICE)),
            (mp.rank_consume, (cfg, spec, refs["consume"], SEED,
                               MESH_DEVICE)),
            (mesh_breakdown_rank, (cfg, spec, MESH_DEVICE))]
    t0 = time.perf_counter()
    launch = mp.launch_coordinated(mp.rank_batch, world, (jobs,),
                                   backend="gloo", timeout=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    check(launch.exit_codes == {}, f"mesh ranks died: {launch.exit_codes}")
    ranks = launch.results
    res = [dict(zip(runs, r[0])) for r in ranks]  # per rank, by run name
    logistic = [r[1][0] for r in ranks]
    entered, joined = (max(st[k] for st in launch.stamps)
                       for k in ("entered", "joined"))
    log(f"mesh: {cfg.P} x {cfg.Q} grid, {world} ranks on one card, "
        f"transport: {MESH_TRANSPORT}; one spawn of {spawn_s:.1f} s: the "
        f"last rank up (interpreter and imports) at {entered:.1f} s, in the "
        f"process group at {joined:.1f} s, then the tile draws and every "
        "run below")

    # every rank returns the same state and history, bitwise
    for name in runs:
        for r in range(1, world):
            a, b = res[0][name], res[r][name]
            check(a["history"] == b["history"] and a["t"] == b["t"] and
                  (a["w"] is None or np.array_equal(a["w"], b["w"])),
                  f"mesh {name}: rank {r} differs from rank 0")
    for r in range(1, world):
        check(np.array_equal(logistic[r]["w"], logistic[0]["w"]) and
              logistic[r]["history"] == logistic[0]["history"],
              f"mesh logistic: rank {r} differs from rank 0")

    # one launch a rank an iteration; a resume launches only its own
    want = {"warm-up": RECORD_EVERY, "interrupted": RESUME_SEGMENT,
            "resumed": ITERS - RESUME_SEGMENT}
    for name in runs:
        n = [res[r][name]["launches"] for r in range(world)]
        check(n == [want.get(name, ITERS)] * world,
              f"mesh {name}: sodda_inner launches by rank {n}")
    log(f"mesh launches: every rank launched sodda_inner at {MESH_SHAPE} "
        f"once an iteration: {ITERS} in each {ITERS}-iteration run, "
        f"{RESUME_SEGMENT} before the interruption and "
        f"{ITERS - RESUME_SEGMENT} in the resume")

    main = res[0]["shard_map+cuda"]
    # consume_local bitwise consume_update from the same w and mu
    for (w, mu, t, _), got in zip(refs["consume"], ranks[0][3]):
        check(np.array_equal(got, refs["ws"][t]),
              f"mesh consume_local at t={t} is not consume_update, bitwise "
              f"(max|d| {float(np.abs(got - refs['ws'][t]).max()):.3e})")
    log(f"mesh consume_local: bitwise consume_update (cuda) from the same w "
        f"and mu at t = {MESH_CONSUME_TS}")
    # every step from cuda's state, to F32_REDUCTION
    worst = 0.0
    for t, got in enumerate(ranks[0][2], start=1):
        tol.assert_trajectories_close([refs["ws"][t]], [got],
                                      tol.F32_REDUCTION,
                                      f"mesh step {t} from cuda's w^{t - 1}")
        worst = max(worst, float(np.abs(got - refs["ws"][t]).max()))
    log(f"mesh steps: each of the {ITERS} iterations, stepped by the mesh "
        f"from cuda's iterate, within F32_REDUCTION of cuda's step; "
        f"max|dw| {worst:.3e}")
    # the trajectory against cuda (hinge), and the logistic twin in full
    held, _ = hold_mesh_trajectory("shard_map+cuda vs cuda (hinge)",
                                   refs["h_c"], main["history"],
                                   refs["ws"][-1], main["w"])
    held_l, _ = hold_mesh_trajectory(
        "shard_map+cuda vs cuda (logistic twin)", refs["h_l"],
        logistic[0]["history"], refs["w_l"], logistic[0]["w"])
    check(held_l, "mesh logistic twin departs from cuda")
    if not held:
        X, y = TiledDataPlane(SEED, cfg.N, cfg.M, cfg.P, cfg.Q).materialize()
        w_c, w_m = (torch.tensor(v, device="cuda")
                    for v in (refs["ws"][-1], main["w"]))
        log(f"mesh hinge: rows of X on other sides of the hinge kink at the "
            f"final iterates, mesh vs cuda: {kink_sides(X, y, w_m, w_c)} of "
            f"{cfg.N}; every step from the same state held, the logistic "
            "twin held in full (a finding: the mesh sums z over "
            f"{cfg.Q} partial GEMVs)")
        del X, y, w_c, w_m
        torch.cuda.empty_cache()
    for name in runs:
        h = res[0][name]["history"]
        if h is not None:
            check(all(math.isfinite(f) for _, f in h) and h[-1][1] < h[0][1],
                  f"mesh {name}: no descent or non-finite {h}")

    # async-mesh: staleness 0 bitwise, staleness 1 within STALENESS
    a0, a1 = res[0]["async-mesh/0"], res[0]["async-mesh/1"]
    check(a0["history"] == main["history"] and
          np.array_equal(a0["w"], main["w"]),
          "async-mesh at staleness 0 is not shard_map+cuda, bitwise")
    tol.assert_objectives_close(refs["h_a"][-1][1], a1["history"][-1][1],
                                tol.STALENESS, "async-mesh/1 vs async")
    log(f"mesh async-mesh: staleness 0 bitwise shard_map+cuda; staleness 1 "
        f"F {a1['history'][-1][1]:.6f} within STALENESS of async's "
        f"{refs['h_a'][-1][1]:.6f}")
    # the wires: int8 within QUANTIZED, the delta all-reduce F32_REDUCTION
    q8, dp = res[0]["int8"], res[0]["delta-psum"]
    tol.assert_objectives_close(main["history"][-1][1], q8["history"][-1][1],
                                tol.QUANTIZED, "mesh int8 wires")
    held_d, _ = hold_mesh_trajectory("delta all-reduce vs all-gather",
                                     main["history"], dp["history"],
                                     main["w"], dp["w"])
    check(held_d, "mesh delta all-reduce departs from the all-gather")
    log(f"mesh int8 wires: F {q8['history'][-1][1]:.6f} within QUANTIZED of "
        f"the exact run's {main['history'][-1][1]:.6f}")

    # interrupted at the seam and resumed: bitwise, rank 0 alone wrote
    it, rs = res[0]["interrupted"], res[0]["resumed"]
    check(it["interrupted"] == RESUME_SEGMENT and
          rs["history"] == main["history"] and
          np.array_equal(rs["w"], main["w"]),
          "mesh resume is not the uninterrupted run, bitwise")
    saves = [(res[r]["interrupted"]["saves"], res[r]["resumed"]["saves"])
             for r in range(world)]
    check(saves == [(1, 1)] + [(0, 0)] * (world - 1),
          f"mesh checkpoint saves by rank: {saves}")
    _, leaves = read_manifest_by_hand(os.path.join(
        d, f"step_{ITERS:010d}"))
    check(np.array_equal(leaves[".w"], main["w"]),
          "mesh checkpoint: w is not the run's final iterate")
    log(f"mesh resumable: interrupted after its commit at {RESUME_SEGMENT} "
        "and resumed in the same ranks, bitwise the uninterrupted run; rank "
        "0 alone saved (one save a boundary), the checkpoint in the "
        "reference's layout")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)

    # what the card measured: time, payload, memory (reported, no limit)
    x_bytes = 4 * cfg.N * cfg.M
    peak = sum(res[r]["shard_map+cuda"]["peak"] or 0 for r in range(world))
    used = max(res[r]["shard_map+cuda"]["device_used"] or 0
               for r in range(world))
    for name in ("shard_map+cuda", "async-mesh/1", "int8", "delta-psum"):
        secs = [res[r][name]["seconds"] for r in range(world)]
        log(f"mesh {name}: {1e3 * secs[0] / ITERS:.3f} ms/iteration on rank "
            f"0 ({1e3 * max(secs) / ITERS:.3f} slowest rank), {ITERS} "
            f"iterations with the objective every {RECORD_EVERY}")
    for name, flags in (("shard_map+cuda", {}),
                        ("int8", dict(compress_z=True, compress_mu=True)),
                        ("delta-psum", dict(gather_deltas=False))):
        pay = res[0][name]["payload"]
        per_it = {k: pay.get(k, 0) / ITERS for k in ("z", "mu", "delta")}
        ring = cdist.iteration_collective_bytes(cfg, **flags)
        log(f"mesh {name} payload a rank an iteration (bytes handed to "
            f"each collective): {per_it}; ring volume "
            f"(iteration_collective_bytes) {ring}; objective "
            f"{pay.get('objective', 0)} and final gather "
            f"{pay.get('gather', 0)} bytes a run")
    log(f"mesh memory: the ranks' max_memory_allocated sum to "
        f"{peak / 1e9:.3f} GB = {peak / x_bytes:.4f} x X "
        f"(X = {x_bytes / 1e9:.3f} GB); the card's used memory at the end "
        f"of the run (every context) {used / 1e9:.3f} GB")
    breakdown, world_ms, w_b = ranks[0][4]
    check(np.array_equal(w_b, main["w"]),
          "mesh breakdown: its timed run does not give shard_map+cuda's "
          "iterate")
    slowest = {k: max(r[4][0][k] for r in ranks) for k in breakdown}
    step = [k for k in breakdown if "objective" not in k]
    log("mesh breakdown of a shard_map+cuda iteration on rank 0, the "
        "engine's bundle with the device synchronised around each "
        "collective, mean of iterations 2-20 (slowest rank in brackets): "
        + ", ".join(f"{k} {v:.3f} ({slowest[k]:.3f}) ms"
                    for k, v in breakdown.items())
        + f"; the step {sum(breakdown[k] for k in step):.3f} ms; its "
        "iterate bitwise the run's")
    log(f"mesh: an all-reduce of {cfg.n} f32 ({4 * cfg.n} bytes) over all "
        f"{world} ranks on cuda:0 tensors, mean of {ITERS}: "
        f"{world_ms:.3f} ms on rank 0")
    log(f"mesh kernel at {MESH_SHAPE}: {ms_b1:.5f} ms by a CUDA graph, bound "
        f"{bound_b1:.5f} ms ({by_b1}), {ms_b1 / bound_b1:.1f}x; "
        f"{world} launches an iteration across the ranks")
    return ms_b1


def phase_nccl():
    """The mesh path on one rank over NCCL (a 1 x 1 grid), bitwise cuda on
    the same data: the only NCCL run one card allows."""
    from repro_torch.testing import multiprocess as mp

    cfg = NCCL_CFG
    spec = ("tiled", SEED, cfg.N, cfg.M, 1, 1)
    plane = TiledDataPlane(*spec[1:])
    st, hist = driver.run(SEED, plane, cfg, ITERS, "cuda",
                          record_every=RECORD_EVERY)
    run = dict(backend="shard_map+cuda", iters=ITERS,
               record_every=RECORD_EVERY, seed=SEED)
    launch = mp.launch_coordinated(mp.rank_runs, 1, (cfg, spec, [run],
                                                     MESH_DEVICE),
                                   backend="nccl", timeout=300)
    check(launch.exit_codes == {}, f"nccl rank died: {launch.exit_codes}")
    got = launch.results[0][0]
    check(got["launches"] == ITERS,
          f"nccl 1x1: {got['launches']} launches in {ITERS} iterations")
    check(got["history"] == hist and
          np.array_equal(got["w"], st.w.cpu().numpy()),
          f"nccl 1x1 mesh is not cuda, bitwise: {got['history']} vs {hist}")
    log(f"mesh 1 x 1 over NCCL ({cfg.N} x {cfg.M}): bitwise the cuda "
        f"backend on the same data, w and history; {ITERS} launches; "
        f"transport: NCCL on cuda:0 tensors")


# ---------------------------------------------------------------------------
# The elastic rescale and the streaming plane on the mesh: one spawn of the
# 15 ranks and 6 spares for the regrown rows
# ---------------------------------------------------------------------------
MESH_LOSE, MESH_REGROW = 10, 15  # the lost row leaves at 10, returns at 15
MESH_SHRUNK_SHAPE = (1, TABLE1_250K_18K.L,
                     TABLE1_250K_18K.M // (ELASTIC_P * TABLE1_250K_18K.Q))
# run_elastic_auto: the last rank's supervisor clock (a FakeClock, as every
# rank's) reads the segment from 5 as 30 s slow; the group's max makes it
# every rank's straggler, flagged at the boundary at 10 against the one
# segment before it
MESH_STRAGGLER = (TABLE1_250K_18K.P * TABLE1_250K_18K.Q - 1, RECORD_EVERY,
                  30.0)
MESH_POLICY = dict(window=3, warmup=1)
MESH_WINDOWS = ITERS // STREAM_SEGMENT


class RegrowableRows(DenseDataPlane):
    """The tiled plane's X, resident, as a dense plane that can regrow:
    its lost partitions regenerate from the tiled plane's seed."""

    def __init__(self, X, y, grid, seed, flip_prob=0.01):
        super().__init__(X, y, grid=grid)
        self.seed, self.flip_prob = seed, flip_prob


def phase_mesh_elastic_refs(cfg, X, y):
    """The single-device elastic runs the mesh's are held to, on the
    tiled plane's X: run_elastic on cuda shrinking P 5 -> 4 at 10 (and
    growing back at 15), on async at staleness 1, and the logistic twin's
    shrink; plus, window by window, the tile digests of each stream
    window's (p, q) slices and cuda's stream run (hinge: its iterate at
    every iteration, the states the streaming mesh steps from; and the
    logistic twin)."""
    data = RegrowableRows(X, y, (cfg.P, cfg.Q), SEED)
    kw = dict(segment_iters=STREAM_SEGMENT, record_every=RECORD_EVERY,
              lose_partition_at=MESH_LOSE, new_P=ELASTIC_P)
    lcfg = dataclasses.replace(cfg, name=cfg.name + "-logistic",
                               loss="logistic")
    # cuda's trajectory on the shrunk grid, a step at a time from w^10:
    # the states the mesh steps from on the re-formed 4 x 3 group
    state, _ = driver.run(SEED, data, cfg, MESH_LOSE, "cuda",
                          record_every=RECORD_EVERY)
    new_cfg = engine.rescale_config(cfg, ELASTIC_P)
    Xs, ys = shrink_plane(data, ELASTIC_P).materialize()
    shrunk = engine.make_bundle(new_cfg, "cuda")
    ws = [state.w.cpu().numpy()]
    for _ in range(MESH_LOSE, ITERS):
        state = shrunk.step(state, Xs, ys)
        ws.append(state.w.cpu().numpy())
    del Xs, ys
    refs = {"steps": ws}
    for name, run_cfg, backend, extra in (
            ("shrink", cfg, "cuda", {}),
            ("grow", cfg, "cuda", dict(regrow_at=MESH_REGROW,
                                       regrow_P=cfg.P)),
            ("async", cfg, "async", dict(staleness=1)),
            ("logistic", lcfg, "cuda", {})):
        st, hist, report = run_elastic(
            SEED, data, run_cfg, ITERS, backend,
            checkpoint_dir=ckpt_dir("elastic-ref-" + name), **kw, **extra)
        refs[name] = dict(w=st.w.cpu().numpy(), history=hist,
                          events=report["events"], cfg=run_cfg)
        torch.cuda.empty_cache()
    del data
    stream = stream_plane(cfg)
    n, m = cfg.n, cfg.m
    digests = []
    # threadless_stream_run's loop for both losses, a window at a time
    runs = {c.loss: dict(cfg=c, bundle=engine.make_bundle(c, "cuda"),
                         state=sodda.init_state(SEED, cfg.M, X.device),
                         ws=[], hist=[]) for c in (cfg, lcfg)}
    for e in range(MESH_WINDOWS):
        Xw, yw = stream.at_epoch(e).materialize()
        digests.append({(p, q): (tile_digest(Xw[p * n:(p + 1) * n,
                                                q * m:(q + 1) * m]),
                                 tile_digest(yw[p * n:(p + 1) * n]))
                        for p in range(cfg.P) for q in range(cfg.Q)})
        for r in runs.values():
            for it in range(e * STREAM_SEGMENT, (e + 1) * STREAM_SEGMENT):
                r["ws"].append(r["state"].w.cpu().numpy())
                if it % RECORD_EVERY == 0:
                    r["hist"].append(losses.objective(r["cfg"].loss, Xw, yw,
                                                      r["state"].w))
                r["state"] = r["bundle"].step(r["state"], Xw, yw)
        if e == MESH_WINDOWS - 1:
            for r in runs.values():
                r["hist"].append(losses.objective(r["cfg"].loss, Xw, yw,
                                                  r["state"].w))
        del Xw, yw
        torch.cuda.empty_cache()
    refs["digests"] = digests
    for name, r in (("stream", runs[cfg.loss]),
                    ("stream-logistic", runs[lcfg.loss])):
        refs[name] = dict(
            ws=r["ws"] + [r["state"].w.cpu().numpy()],
            history=list(zip(driver.record_ticks(ITERS, RECORD_EVERY),
                             torch.stack(r["hist"]).tolist())))
    check(np.array_equal(ws[-1], refs["shrink"]["w"]),
          "mesh elastic refs: cuda stepped on the survivors is not "
          "run_elastic's trajectory")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    log(f"mesh elastic refs: run_elastic on cuda (P {cfg.P} -> {ELASTIC_P} at "
        f"{MESH_LOSE}, and back to {cfg.P} at {MESH_REGROW}), async at "
        f"staleness 1 and the logistic twin, segments of {STREAM_SEGMENT}; "
        f"tile digests of the {MESH_WINDOWS} stream windows' slices")
    return refs


def mesh_elastic_runs(root, lcfg, ws):
    """The spawn's elastic runs, in order (``rank_elastic``): the main
    shrink-then-grow run (a fault after its last commit), its composition
    by hand, the shrink with a fault in each of its phases and by hand,
    the straggler's automatic shrink, async-mesh, the logistic twin, and
    a step from each of cuda's states `ws` on the re-formed 4 x 3 group."""
    def run(kind, name, backend="shard_map+cuda", **extra):
        base = dict(kind=kind, backend=backend, iters=ITERS,
                    record_every=RECORD_EVERY, seed=SEED,
                    segment_iters=STREAM_SEGMENT, new_P=ELASTIC_P,
                    checkpoint_dir=os.path.join(root, name))
        if kind != "auto":
            base["lose_at"] = MESH_LOSE
        return dict(base, **extra)

    grow = dict(regrow_at=MESH_REGROW, regrow_P=TABLE1_250K_18K.P)
    return {"grow": run("elastic", "grow", faults={ITERS: 1}, **grow),
            "hand-grow": run("by-hand", "hand-grow", **grow),
            "shrink": run("elastic", "shrink",
                          faults={RECORD_EVERY: 1, MESH_REGROW: 1}),
            "hand": run("by-hand", "hand"),
            "auto": run("auto", "auto", straggler=MESH_STRAGGLER,
                        policy=MESH_POLICY, patience=1),
            "async": run("elastic", "async", "async-mesh",
                         options={"staleness": 1}),
            "logistic": run("elastic", "logistic", cfg=lcfg),
            "steps": run("steps", "steps", ws=ws[:-1],
                         ts=list(range(MESH_LOSE + 1, ITERS + 1)))}


def mesh_resumable(root, name, iters):
    """A ``shard_map+cuda`` ``run_resumable`` of ``rank_runs`` in segments
    of 5 (a window a segment on a streaming plane, prefetch depth 1)."""
    return dict(backend="shard_map+cuda", iters=iters,
                record_every=RECORD_EVERY, seed=SEED,
                resumable=dict(checkpoint_dir=os.path.join(root, name),
                               segment_iters=STREAM_SEGMENT,
                               prefetch_depth=1))


def segment_ms(run):
    """ms an iteration of a run from its first segment's start to its
    last segment's end (its timeline), set-up left out as phase_streaming
    leaves it out."""
    at = {(e, d): t for e, d, t, _ in run["timeline"]}
    last = max(d for e, d in at if e == "end")
    return 1e3 * (at[("end", last)] - at[("start", 0)]) / last


def mesh_elastic_spawn(cfg, refs):
    """One spawn of the 5 x 3 grid and 6 spares over gloo on the card:
    the streaming runs, each rank's tile of every window, the static runs
    they are compared with, a step from each of cuda's stream states on
    its window, then the elastic runs. Returns what the phases read."""
    from repro_torch.testing import multiprocess as mp

    world = cfg.P * cfg.Q
    root = ckpt_dir("mesh-elastic")
    stream_spec = ("streaming", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    tiled_spec = ("tiled", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    lcfg = refs["logistic"]["cfg"]
    streams = [mesh_resumable(root, "stream", ITERS),
               mesh_resumable(root, "one-window", STREAM_SEGMENT)]
    statics = [mesh_resumable(root, "static", ITERS),
               mesh_resumable(root, "static-one", STREAM_SEGMENT)]
    elastic = mesh_elastic_runs(root, lcfg, refs["steps"])
    spares = sum((r["regrow_P"] - ELASTIC_P) * cfg.Q
                 for r in elastic.values() if "regrow_at" in r)
    ws = refs["stream"]["ws"]
    steps = [(mp.rank_steps, (
        cfg, stream_spec, "shard_map+cuda",
        ws[e * STREAM_SEGMENT:(e + 1) * STREAM_SEGMENT],
        list(range(e * STREAM_SEGMENT + 1, (e + 1) * STREAM_SEGMENT + 1)),
        SEED,
        None, None, MESH_DEVICE, e)) for e in range(MESH_WINDOWS)]
    jobs = [(mp.rank_runs, (cfg, stream_spec, streams, MESH_DEVICE)),
            (mp.rank_runs, (lcfg, stream_spec,
                            [mesh_resumable(root, "logistic", ITERS)],
                            MESH_DEVICE)),
            (mp.rank_tiles, (cfg, stream_spec, list(range(MESH_WINDOWS)),
                             MESH_DEVICE)),
            (mp.rank_runs, (cfg, tiled_spec, statics, MESH_DEVICE)),
            *steps,
            (mp.rank_elastic, (cfg, tiled_spec, list(elastic.values()),
                               MESH_DEVICE))]
    free, total = torch.cuda.mem_get_info()
    log(f"mesh elastic spawn: the card's used memory before it "
        f"{(total - free) / 1e9:.3f} GB (this process: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved)")
    t0 = time.perf_counter()
    launch = mp.launch_coordinated(mp.rank_batch, world, (jobs,),
                                   backend="gloo", spares=spares,
                                   timeout=MESH_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    check(launch.exit_codes == {},
          f"mesh elastic spawn: processes died: {launch.exit_codes}"
          + raised(launch))
    ranks = launch.results[:world]
    log(f"mesh elastic spawn: {world} ranks and {spares} spares on one card "
        f"over gloo, {spawn_s:.1f} s: the last process up at "
        f"{max(st['entered'] for st in launch.stamps):.1f} s, the last rank "
        f"in the group at "
        f"{max(st['joined'] for st in launch.stamps[:world]):.1f} s, then "
        "every run below")
    return dict(
        launch=launch, world=world, spares=spares,
        stream={"stream": [r[0][0] for r in ranks],
                "one-window": [r[0][1] for r in ranks],
                "logistic": [r[1][0] for r in ranks],
                "static": [r[3][0] for r in ranks],
                "static-one": [r[3][1] for r in ranks]},
        tiles=[r[2] for r in ranks],
        steps=np.concatenate([ranks[0][4 + e] for e in range(MESH_WINDOWS)]),
        steps_equal=all(np.array_equal(r[4 + e], ranks[0][4 + e])
                        for r in ranks for e in range(MESH_WINDOWS)),
        elastic={name: [res[-1][k] if res[-1] is not None else None
                        for res in launch.results]
                 for k, name in enumerate(elastic)})


def raised(launch):
    """What the processes of a failed launch raised: each one's last
    traceback line, and in full the first traceback that is not a peer's
    closed connection (the consequence of another process's fault)."""
    if not launch.errors:
        return ""
    lines = {r: tb.strip().splitlines()[-1] for r, tb in launch.errors.items()}
    cause = [r for r, line in sorted(lines.items())
             if "Connection closed" not in line and
             "Connection reset" not in line] or sorted(lines)
    return (f"; raised: {lines}; process {cause[0]}:\n"
            f"{launch.errors[cause[0]]}")


def same_on_every_rank(name, results):
    """The finished results of a run: every one's w, history and report
    bitwise equal. Returns them."""
    done = [r for r in results if r is not None and r.get("left") is None]
    for r in done[1:]:
        check(r["history"] == done[0]["history"] and
              np.array_equal(r["w"], done[0]["w"]) and
              r.get("report") == done[0].get("report"),
              f"mesh {name}: a rank differs from rank 0")
    return done


def phase_mesh_elastic(cfg, spawn, refs):
    """run_elastic, run_elastic_auto and the composition by hand on the
    5 x 3 mesh, shrunk to 4 x 3 at 10 (the kernel at (1, 64, 1500)) and
    regrown at 15 (see the module docstring, 12)."""
    world, launch = spawn["world"], spawn["launch"]
    runs = dict(spawn["elastic"])
    steps = runs.pop("steps")
    lost = list(range(ELASTIC_P * cfg.Q, world))
    shrinks = [3 * k for k in range(len(runs) + 1)]  # and the steps'
    check(launch.departed == {r: shrinks for r in lost},
          f"mesh elastic: planned departures {launch.departed}, expected "
          f"ranks {lost} at generations {shrinks}")

    # each step on the re-formed 4 x 3 group from cuda's state
    steps = [r["steps"] for r in steps[:world] if r["left"] is None]
    check(len(steps) == ELASTIC_P * cfg.Q and
          all(np.array_equal(s, steps[0]) for s in steps),
          "mesh elastic steps: the survivors differ")
    worst = 0.0
    for k, got in enumerate(steps[0]):
        want = refs["steps"][k + 1]
        tol.assert_trajectories_close(
            [want], [got], tol.F32_REDUCTION,
            f"mesh step {MESH_LOSE + k + 1} on the 4 x 3 grid")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"mesh elastic steps: each of iterations {MESH_LOSE + 1}-{ITERS}, "
        "stepped on the re-formed 4 x 3 group from cuda's iterate on the "
        f"survivors, within F32_REDUCTION of cuda's step; max|dw| "
        f"{worst:.3e}")

    done = {name: same_on_every_rank("elastic " + name, res)
            for name, res in runs.items()}
    for name, res in runs.items():
        grows = name in ("grow", "hand-grow")
        want = world if grows else ELASTIC_P * cfg.Q
        check(len(done[name]) == want and
              all(r["world"] == want for r in done[name]),
              f"mesh elastic {name}: {len(done[name])} ranks finished")
        left = [r for r in res[:world] if r["left"] is not None]
        check([r["left"] for r in left] == [MESH_LOSE] * len(lost),
              f"mesh elastic {name}: lost ranks left at "
              f"{[r['left'] for r in left]}")
        # one launch a rank an iteration run: the lost row's 10 before it
        # left, a regrown rank's 5, and none on a resume of a completed
        # phase (the faults after the last commits)
        n = [r["launches"] for r in res if r is not None]
        expect = [ITERS] * (ELASTIC_P * cfg.Q) + [MESH_LOSE] * len(lost) + (
            [ITERS - MESH_REGROW] * (world - ELASTIC_P * cfg.Q)
            if grows else [])
        check(n == expect, f"mesh elastic {name}: sodda_inner launches by "
              f"process {n}, expected {expect}")
        for r in done[name]:
            at = {(e, d): n for e, d, _, n in r["timeline"]}
            if ("end", MESH_REGROW) in at and ("start", MESH_LOSE) in at:
                k = at[("end", MESH_REGROW)] - at[("start", MESH_LOSE)]
                check(k == MESH_REGROW - MESH_LOSE,
                      f"mesh elastic {name}: {k} launches on the 4 x 3 grid")
    check(done["grow"][0]["report"]["new_cfg"].m_tilde == MESH_SHRUNK_SHAPE[2],
          f"mesh elastic: shrunk m_tilde "
          f"{done['grow'][0]['report']['new_cfg'].m_tilde}")
    log(f"mesh elastic launches: every rank launched sodda_inner once an "
        f"iteration it ran: 20 a survivor, {MESH_LOSE} a lost rank before "
        f"it left, {ITERS - MESH_REGROW} a regrown rank, the "
        f"{MESH_REGROW - MESH_LOSE} on the 4 x 3 grid at {MESH_SHRUNK_SHAPE};"
        " none on a resume of a completed phase")

    spares = launch.results[world:]
    held = [r for res in spares for r in res[-1] if r is not None]
    check(len(held) == spawn["spares"] and
          all(r["held"] == {"group": False, "cuda": False} for r in held),
          f"mesh elastic: regrown ranks held {[r['held'] for r in held]}")
    log(f"mesh elastic: ranks {lost} left the group at every shrink (exit "
        f"0, a planned departure); the {spawn['spares']} regrown ranks "
        "joined holding no group and no device context, each for one run")

    for a, b in (("grow", "hand-grow"), ("shrink", "hand"), ("auto", "hand")):
        x, z = done[a][0], done[b][0]
        check(x["history"] == z["history"] and np.array_equal(x["w"], z["w"]),
              f"mesh elastic {a} is not {b}, bitwise")
    events = done["shrink"][0]["report"]["events"]
    check([e for e in events if e.startswith("restart")] ==
          [f"restart#1@{RECORD_EVERY}:Preemption",
           f"restart#1@{MESH_REGROW}:Preemption"],
          f"mesh elastic shrink: events {events}")
    auto = done["auto"][0]["report"]
    check(auto["rescaled"] and auto["boundary"] == MESH_LOSE and
          f"straggler@{MESH_LOSE}:{MESH_STRAGGLER[2]:.3f}s" in auto["events"],
          f"mesh elastic auto: {auto}")
    log("mesh elastic: run_elastic bitwise its composition by hand "
        "(run_resumable, the group re-formed, rescale_bundle, "
        "migrate_resumable, run_resumable) for the shrink and the "
        "shrink-then-grow; faults after commits in every phase retried "
        "bitwise; the straggler (rank "
        f"{MESH_STRAGGLER[0]}'s segment from {MESH_STRAGGLER[1]}) shrunk away "
        f"at {MESH_LOSE} on every rank alike, bitwise the planned shrink; "
        f"events {auto['events']}")

    held_s, _ = hold_mesh_trajectory(
        "elastic shrink vs cuda run_elastic (hinge)",
        refs["shrink"]["history"], done["shrink"][0]["history"],
        refs["shrink"]["w"], done["shrink"][0]["w"])
    held_g, _ = hold_mesh_trajectory(
        "elastic shrink-then-grow vs cuda run_elastic (hinge)",
        refs["grow"]["history"], done["grow"][0]["history"],
        refs["grow"]["w"], done["grow"][0]["w"])
    held_l, _ = hold_mesh_trajectory(
        "elastic shrink vs cuda run_elastic (logistic twin)",
        refs["logistic"]["history"], done["logistic"][0]["history"],
        refs["logistic"]["w"], done["logistic"][0]["w"])
    check(held_l, "mesh elastic logistic twin departs from cuda")
    if not (held_s and held_g):
        log("mesh elastic hinge: a finding, the hinge trajectory parts from "
            "cuda's (queue C); the logistic twin held in full")
    for name in ("shrink", "grow"):
        got, want = ([e for e in events if e.startswith("rescale")]
                     for events in (done[name][0]["report"]["events"],
                                    refs[name]["events"]))
        check(got == want, f"mesh elastic {name}: rescale events {got}, "
              f"run_elastic's {want}")
    a1 = done["async"][0]["history"][-1][1]
    tol.assert_objectives_close(refs["async"]["history"][-1][1], a1,
                                tol.STALENESS, "elastic async-mesh vs async")
    log(f"mesh elastic async-mesh: F {a1:.6f} within STALENESS of async's "
        f"{refs['async']['history'][-1][1]:.6f} under the same shrink")
    for name, r in done.items():
        h = r[0]["history"]
        check(all(math.isfinite(f) for _, f in h) and h[-1][1] < h[0][1],
              f"mesh elastic {name}: no descent or non-finite {h}")

    # what the card measured: segment times, the rebuilds, memory
    main = done["grow"][0]
    at = {(e, d): t for e, d, t, _ in main["timeline"]}
    seg = [(d, 1e3 * (at[("end", d + STREAM_SEGMENT)] - at[("start", d)]) /
            STREAM_SEGMENT) for d in range(0, ITERS, STREAM_SEGMENT)]
    shrink_s = at[("start", MESH_LOSE)] - at[("end", MESH_LOSE)]
    grow_s = at[("start", MESH_REGROW)] - at[("end", MESH_REGROW)]
    regrown = [r for r in runs["grow"][world:] if r is not None]
    joined_s = max(
        {(e, d): t for e, d, t, _ in r["timeline"]}[("start", MESH_REGROW)]
        for r in regrown) - at[("end", MESH_REGROW)]
    x_bytes = 4 * cfg.N * cfg.M
    peak = sum(r["peak"] or 0 for r in runs["grow"] if r is not None)
    used = max(r["device_used"] or 0 for r in runs["grow"] if r is not None)
    rendezvous = [h["end"] - h["start"]
                  for st in launch.stamps[:ELASTIC_P * cfg.Q]
                  for h in st["history"] if h["event"] == "joined"
                  and h["generation"] in (1, 2)]
    log("mesh elastic shrink-then-grow (rank 0, shard_map+cuda): ms an "
        "iteration by segment, " + ", ".join(
            f"[{d}, {d + STREAM_SEGMENT}) {ms:.3f}" for d, ms in seg)
        + f" (5 x 3, 5 x 3, 4 x 3, 5 x 3); {shrink_s:.3f} s from the commit "
        f"at {MESH_LOSE} to the first segment on the 4 x 3 group (barrier, "
        "the lost row's departure, teardown, rendezvous, rescale_bundle, "
        f"migration, placement), {grow_s:.3f} s from the commit at "
        f"{MESH_REGROW} to the first on the regrown group; the regrown "
        f"ranks in the group with their tiles {joined_s:.3f} s after that "
        f"commit; each rendezvous {min(rendezvous):.3f}-"
        f"{max(rendezvous):.3f} s; the ranks' max_memory_allocated sum to "
        f"{peak / 1e9:.3f} GB = {peak / x_bytes:.4f} x X; the card's used "
        f"memory {used / 1e9:.3f} GB")
    # the rebuilds' parts, timed in the run (SegmentSupervisor.rebuilds)
    for r in main["rebuilds"]:
        log(f"mesh elastic rebuild at {r['at']} onto {r['grid'][0]} x "
            f"{r['grid'][1]} (rank 0, timed in the run): "
            f"{r['reform_s']:.3f} s from the commit to the new group "
            f"(barrier, departures, teardown; the rendezvous itself "
            f"{r['rendezvous_s']:.3f} s), {r['mesh_s']:.3f} s the mesh and "
            f"bundle, {r['migrate_s']:.3f} s the migration (the fingerprint "
            "of the resident tile, the save, the barrier), then "
            f"{at[('start', r['at'])] - r['end']:.3f} s the phase's set-up "
            "to its first segment (the resident tile and the kept stamp: "
            "no tile drawn, none hashed)")
    for r in regrown:
        b = r["rebuilds"][0]
        start = {(e, d): t for e, d, t, _ in r["timeline"]}[
            ("start", MESH_REGROW)]
        log(f"mesh elastic regrown rank: rendezvous {b['rendezvous_s']:.3f} "
            f"s (waiting from launch for the survivors' commit at "
            f"{MESH_REGROW}), the mesh and bundle {b['mesh_s']:.3f} s, the "
            f"migration {b['migrate_s']:.3f} s, then {start - b['end']:.3f} "
            "s drawing its own tile and warming up to its first segment")
    for name, res in done.items():
        at = {}
        for e, d, t, _ in res[0]["timeline"]:
            at.setdefault((e, d), t)  # a retried boundary: its first pass
        segs = [1e3 * (at[("end", d + STREAM_SEGMENT)] - at[("start", d)])
                / STREAM_SEGMENT for d in range(0, ITERS, STREAM_SEGMENT)
                if ("start", d) in at and ("end", d + STREAM_SEGMENT) in at]
        segs = [f"{ms:.3f}" for ms in segs]
        secs = max(r["seconds"] for r in res if r["held"] is None)
        log(f"mesh elastic {name}: ms an iteration by segment of 5 on rank "
            f"0 {segs}; {secs:.3f} s for the run (the slowest rank of the "
            "launch's group; set-up, rescales and retries included)")


def phase_mesh_elastic_killed(cfg, spawn):
    """The shrink-then-grow run killed after its commit at 15, inside the
    shrunk phase (every survivor exits), then rerun in a second spawn with
    the regrown row's spares: bitwise the uninterrupted run, no launch on
    a resume of a completed phase."""
    from repro_torch.testing import multiprocess as mp

    world, survivors = cfg.P * cfg.Q, ELASTIC_P * cfg.Q
    run = dict(kind="elastic", backend="shard_map+cuda", iters=ITERS,
               record_every=RECORD_EVERY, seed=SEED,
               segment_iters=STREAM_SEGMENT, new_P=ELASTIC_P,
               lose_at=MESH_LOSE, regrow_at=MESH_REGROW, regrow_P=cfg.P,
               checkpoint_dir=ckpt_dir("mesh-killed"))
    spec = ("tiled", SEED, cfg.N, cfg.M, cfg.P, cfg.Q)
    out, secs = [], []
    for kill, spares in ((MESH_REGROW, 0), (None, world - survivors)):
        t0 = time.perf_counter()
        out.append(mp.launch_coordinated(
            mp.rank_elastic, world,
            (cfg, spec, [dict(run, kill_at=kill)], MESH_DEVICE),
            backend="gloo", spares=spares, timeout=MESH_TIMEOUT_S))
        secs.append(time.perf_counter() - t0)
    killed, rerun = out
    check(killed.exit_codes == {r: mp.KILL_EXIT_CODE
                                for r in range(survivors)},
          f"mesh elastic kill: exit codes {killed.exit_codes}"
          + raised(killed))
    check(rerun.exit_codes == {}, f"mesh elastic rerun: processes died "
          f"{rerun.exit_codes}" + raised(rerun))
    want = same_on_every_rank("elastic grow", spawn["elastic"]["grow"])[0]
    got = [res[0] for res in rerun.results]
    done = same_on_every_rank("elastic rerun", got)
    check(len(done) == world and done[0]["history"] == want["history"] and
          np.array_equal(done[0]["w"], want["w"]),
          "mesh elastic: the run killed at 15 and rerun is not the "
          "uninterrupted run, bitwise")
    n = [r["launches"] for r in got]
    expect = ([ITERS - MESH_REGROW] * survivors + [0] * (world - survivors)
              + [ITERS - MESH_REGROW] * (world - survivors))
    check(n == expect, f"mesh elastic rerun: sodda_inner launches {n}, "
          f"expected {expect}")
    log(f"mesh elastic kill and rerun: the shrink-then-grow run killed "
        f"after its commit at {MESH_REGROW} ({survivors} survivors exited "
        f"{mp.KILL_EXIT_CODE}, the lost row had left at {MESH_LOSE}), "
        f"{secs[0]:.1f} s; rerun with {world - survivors} spares, "
        f"{secs[1]:.1f} s: bitwise the uninterrupted run, launches "
        f"{n} (none for the completed phases)")


def phase_mesh_streaming(cfg, spawn):
    """The streaming plane on the 5 x 3 mesh: 4 windows a segment of 5 at
    depth 1, against the static mesh run of the same spawn and the
    single-device stream (see the module docstring, 12)."""
    world, runs = spawn["world"], spawn["stream"]
    done = {name: same_on_every_rank(name, res)
            for name, res in runs.items()}
    for name, n in (("stream", ITERS), ("one-window", STREAM_SEGMENT),
                    ("logistic", ITERS), ("static", ITERS),
                    ("static-one", STREAM_SEGMENT)):
        got = [r["launches"] for r in done[name]]
        check(got == [n] * world,
              f"mesh streaming {name}: sodda_inner launches {got}")
    one, static_one = done["one-window"][0], done["static-one"][0]
    check(one["history"] == static_one["history"] and
          np.array_equal(one["w"], static_one["w"]),
          "mesh streaming: window 0 is not the tiled mesh run, bitwise")
    for rank, tiles in enumerate(spawn["tiles"]):
        for e, got in enumerate(tiles):
            # digests from the card (arrays when the ranks ran on the CPU)
            got = tuple(g if isinstance(g, int) else
                        tile_digest(torch.as_tensor(g)) for g in got)
            check(got == spawn["refs"]["digests"][e][divmod(rank, cfg.Q)],
                  f"mesh streaming: rank {rank}'s tile of window {e} is not "
                  "the single-device window's slice")
    log(f"mesh streaming: every rank bitwise equal; {ITERS} launches a rank "
        f"({STREAM_SEGMENT} for one window); one window's run bitwise the "
        "tiled mesh run; each rank's tile and label block of every window "
        "bitwise (by digest on the card) the single-device window's slice")

    # each step of the stream from cuda's state, on its window, to
    # F32_REDUCTION: the gate the hinge trajectory's parting leaves
    refs = spawn["refs"]
    check(spawn["steps_equal"], "mesh streaming steps: the ranks differ")
    worst = 0.0
    for t, got in enumerate(spawn["steps"], start=1):
        want = refs["stream"]["ws"][t]
        tol.assert_trajectories_close(
            [want], [got], tol.F32_REDUCTION,
            f"mesh streaming step {t} from cuda's w^{t - 1}")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"mesh streaming steps: each of the {ITERS} iterations, stepped on "
        "the 5 x 3 mesh from cuda's stream iterate on its window's tiles, "
        f"within F32_REDUCTION of cuda's step; max|dw| {worst:.3e}")
    stream, logistic = done["stream"][0], done["logistic"][0]
    held, _ = hold_mesh_trajectory(
        "streaming vs the single-device stream (hinge)",
        refs["stream"]["history"], stream["history"],
        refs["stream"]["ws"][-1], stream["w"])
    held_l, _ = hold_mesh_trajectory(
        "streaming vs the single-device stream (logistic twin)",
        refs["stream-logistic"]["history"], logistic["history"],
        refs["stream-logistic"]["ws"][-1], logistic["w"])
    check(held_l, "mesh streaming logistic twin departs from the "
          "single-device stream")
    if not held:
        log("mesh streaming hinge: a finding, the hinge trajectory parts "
            "from the single-device stream's (queue C); each step from the "
            "same state held above, the logistic twin in full")
    for run in (stream, logistic):
        h = run["history"]
        check(all(math.isfinite(f) for _, f in h) and h[-1][1] < h[0][1],
              f"mesh streaming: no descent or non-finite {h}")

    x_bytes = 4 * cfg.N * cfg.M
    ms = [segment_ms(r) for r in done["stream"]]
    ms_static = [segment_ms(r) for r in done["static"]]
    setup = [r["seconds"] - segment_ms(r) * ITERS / 1e3
             for r in done["stream"]]
    peak = sum((r["peak"] or 0) - (r["allocated"] or 0)
               for r in done["stream"])
    used = max(r["device_used"] or 0 for r in done["stream"])
    stats = [r["stream"] for r in done["stream"]]
    log(f"mesh streaming: {ms[0]:.3f} ms an iteration on rank 0 "
        f"({max(ms):.3f} slowest) against the static mesh run's "
        f"{ms_static[0]:.3f} ({max(ms_static):.3f}) in the same spawn, "
        "both run_resumable in segments of 5 timed from the first segment's"
        f" start; the set-up before it (the resume guard's fingerprint on "
        f"rank 0, window 0 placed cold) {setup[0]:.3f} s on rank 0; "
        "place_s / wait_s / overlap_ratio by rank: "
        + "; ".join(f"{s['place_s']:.4f} / {s['wait_s']:.4f} / "
                    f"{s['overlap_ratio']:.4f}" for s in stats)
        + f"; the ranks' max_memory_allocated above their start sum to "
        f"{peak / 1e9:.3f} GB = {peak / x_bytes:.4f} x X (predicted <= 2.2);"
        f" the card's used memory {used / 1e9:.3f} GB; history "
        f"{[(t, round(f, 6)) for t, f in stream['history']]}")


def phase_mesh_elastic_streaming(cfg, refs):
    """The kernel at the shrunk mesh launch, then one spawn for both
    phases."""
    ms = phase_kernel_at(MESH_SHRUNK_SHAPE, SEED + 4)
    bound, by = kernel_bound_ms(*MESH_SHRUNK_SHAPE)
    log(f"mesh kernel at {MESH_SHRUNK_SHAPE}: {ms:.5f} ms by a CUDA graph, "
        f"bound {bound:.5f} ms ({by}), {ms / bound:.1f}x; "
        f"{ELASTIC_P * TABLE1_250K_18K.Q} launches an iteration across the "
        "4 x 3 grid")
    torch.cuda.empty_cache()
    spawn = mesh_elastic_spawn(cfg, refs)
    spawn["refs"] = refs
    phase_mesh_streaming(cfg, spawn)
    phase_mesh_elastic(cfg, spawn, refs)
    phase_mesh_elastic_killed(cfg, spawn)
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)


# ---------------------------------------------------------------------------
# flash_attention and the gemma2-9b serving path
# ---------------------------------------------------------------------------
def attention_pairs(Sq, Sk, causal=True, window=0, q_offset=0):
    """Unmasked (query, key) pairs of one head: the work the mask leaves."""
    n = 0
    for r in range(Sq):
        qpos = q_offset + r
        hi = min(Sk, qpos + 1) if causal else Sk
        lo = max(0, qpos - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def flash_bound_ms(B, H, KV, Sq, Sk, D, dtype, **mask):
    """Least time for one call: 4 B H D FLOP per unmasked pair (QK^T and
    PV) over the dtype's peak, vs Q, K, V read once and O written once
    over the HBM rate."""
    flops = 4.0 * B * H * D * attention_pairs(Sq, Sk, **mask)
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * Sq * H * D + 2 * B * Sk * KV * D)
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_inputs(B, H, KV, Sq, Sk, D, dtype, gen):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) on the card, unit-variance entries,
    as the model's projections of a normed residual give them."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, Sq, H, D), rnd(B, Sk, KV, D), rnd(B, Sk, KV, D)


def attention_bf16_scores(q, k, v, **opts):
    """The control: attention whose scores are rounded to bf16 before the
    f32 softmax (``attention_naive``'s einsum runs in the input dtype, as
    the JAX reference's does), one batch row at a time."""
    return torch.cat([kref.attention_naive(q[b:b + 1], k[b:b + 1],
                                           v[b:b + 1], **opts)
                      for b in range(q.shape[0])])


def bf16_scale_is_exact(D):
    """Whether sqrt(D) is a bf16 number, so that the plain version's bf16
    scale equals the f32 one."""
    return float(torch.tensor(math.sqrt(D)).to(torch.bfloat16)) == \
        math.sqrt(D)


def bf16_excess(q, k, v, opts, **outs):
    """`tol.half_ulp_excess` against the plain version run on f32 copies of
    the inputs, over max|v|, with a second control among the outputs:
    that plain version with P rounded once to bf16 before P.V, as a
    textbook tensor-core kernel takes it."""
    f = [t.float() for t in (q, k, v)]
    oracle = kref.attention_ref(*f, **opts)
    p_bf16 = kref.attention_ref(*f, p_split=1, **opts).to(q.dtype)
    return tol.half_ulp_excess(oracle, float(v.float().abs().max()),
                               control_p_bf16=p_bf16, **outs)


def check_excess(tag, ex):
    """kernel and plain within the rounding rule; every control outside."""
    held = {k: v for k, v in ex.items() if not k.startswith("control")}
    check(all(v <= F32_NOISE for v in held.values()),
          f"{tag}: beyond half a bf16 ulp of the f32 result by {ex} x "
          f"the output scale (limit {F32_NOISE})")
    controls = {k: v for k, v in ex.items() if k.startswith("control")}
    check(controls and all(v > F32_NOISE for v in controls.values()),
          f"{tag}: a control passes the rounding rule ({ex}), so the rule "
          "cannot tell such a kernel apart")


def phase_flash():
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    S = SERVE_PROMPT
    cases = [
        ("gemma2 local layer", (4, 16, 8, S, S, 256), bf16,
         dict(window=4096, softcap=50.0)),
        ("gemma2 global layer", (4, 16, 8, S, S, 256), bf16,
         dict(softcap=50.0)),
        ("gemma2 decode offset", (4, 16, 8, 1, S, 256), bf16,
         dict(window=4096, softcap=50.0, q_offset=S - 1)),
    ]
    # every other bf16 head dim the wgmma kernel instantiates, unaligned
    for D in (16, 64, 128):
        cases += [
            (f"bf16 D={D} causal", (2, 4, 2, 200, 200, D), bf16, dict()),
            (f"bf16 D={D} non-causal", (2, 4, 2, 200, 200, D), bf16,
             dict(causal=False)),
            (f"bf16 D={D} window+softcap", (2, 4, 2, 200, 200, D), bf16,
             dict(window=64, softcap=30.0)),
            (f"bf16 D={D} decode offset", (2, 4, 2, 1, 200, D), bf16,
             dict(window=64, softcap=30.0, q_offset=199)),
        ]
    cases += [
        ("unaligned causal", (2, 4, 2, 200, 200, 64), f32, dict()),
        ("unaligned non-causal", (2, 4, 2, 200, 200, 64), f32,
         dict(causal=False)),
        ("unaligned window+softcap", (2, 4, 2, 200, 200, 64), f32,
         dict(window=64, softcap=30.0)),
        ("unaligned decode offset", (2, 4, 2, 1, 200, 64), f32,
         dict(window=64, softcap=30.0, q_offset=199)),
    ]
    max_err = 0.0
    for name, (B, H, KV, Sq, Sk, D), dtype, opts in cases:
        q, k, v = flash_inputs(B, H, KV, Sq, Sk, D, dtype, gen)
        a = ops.flash_attention(q, k, v, force="cuda", **opts)
        b = ops.flash_attention(q, k, v, force="cuda", **opts)
        want = ops.flash_attention(q, k, v, force="ref", **opts)
        torch.cuda.synchronize()
        tag = f"flash {name} {(B, H, KV, Sq, Sk, D)} {dtype} {opts}"
        check(torch.equal(a, b), f"{tag}: two launches differ")
        check(bool(torch.isfinite(a).all()), f"{tag}: non-finite output")
        if dtype == bf16:
            ex = bf16_excess(q, k, v, opts, kernel=a, plain=want,
                             control=attention_bf16_scores(q, k, v, **opts))
            # The plain version takes 1 / sqrt(D) rounded to bf16, as the
            # reference does; the kernels and the oracle take it in f32. At
            # D = 128 the two differ (sqrt(128) is no bf16 number), so there
            # the plain version is shown, not held.
            held = {name: e for name, e in ex.items()
                    if name != "plain" or bf16_scale_is_exact(D)}
            check_excess(tag, held)
            rule = (f"excess over half a bf16 ulp / max|v|: kernel "
                    f"{ex['kernel']:.3e}, plain {ex['plain']:.3e}"
                    f"{'' if 'plain' in held else ' (not held)'}, bf16-score "
                    f"control {ex['control']:.3e}, P-in-bf16 control "
                    f"{ex['control_p_bf16']:.3e} (limit {F32_NOISE:.3e}); "
                    f"route {flash_build.route(dtype, D)}")
        else:
            torch.testing.assert_close(a, want, rtol=FLASH_F32_TOL,
                                       atol=FLASH_F32_TOL)
            rule = f"tol {FLASH_F32_TOL}; route {flash_build.route(dtype, D)}"
        err = float((a.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        log(f"{tag}: bitwise across launches, max|kernel-plain| = "
            f"{err:.3e}; {rule}")

    offset_view_case("flash", lambda *t: ops.flash_attention(*t,
                                                            force="cuda"),
                     flash_inputs(2, 4, 2, 200, 200, 64, bf16, gen),
                     (0, 1, 2), flash_build.route(bf16, 64))

    B, H, KV, D = 4, 16, 8, 256  # one gemma2-9b prefill layer
    q, k, v = flash_inputs(B, H, KV, S, S, D, bf16, gen)
    times = {}
    for layer, window in (("local", 4096), ("global", 0)):
        opts = dict(window=window, softcap=50.0)
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda",
                                                 **opts), reps=5, warmup=1)
        plain_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="ref",
                                                       **opts),
                           reps=2, warmup=1)
        bound_ms, bound_by = flash_bound_ms(B, H, KV, S, S, D, bf16,
                                            window=window)
        times[layer] = (ms, plain_ms, bound_ms, bound_by)
        log(f"flash {layer} layer (4, 16, 8, {S}, 256) bf16: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), kernel/bound {ms / bound_ms:.1f}x")
    # the one PyTorch call for the same function: causal, no softcap, no
    # window (a yardstick only; the port never calls it)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10, warmup=2)
    same_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, force="cuda"),
                      reps=5, warmup=1)
    log(f"flash global-layer shape, causal, GQA, no softcap: torch "
        f"scaled_dot_product_attention {sdpa_ms:.4f} ms, the kernel "
        f"{same_ms:.4f} ms")
    ms, plain_ms, bound_ms, bound_by = times["global"]
    record = dict(name="flash_attention", route="cuda",
                  source="src/repro_torch/kernels/csrc/"
                         "flash_attention_wgmma.cu",
                  replaces="src/repro/kernels/flash_attention.py:74",
                  launches=None, max_abs_err=max_err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=sdpa_ms)
    return record, times


def offset_view(t):
    """`t`'s values in a contiguous view that starts one element into its
    buffer, so its data is not 16-byte aligned (as a slice of a flat
    buffer may be)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    check(view.is_contiguous() and view.data_ptr() % 16 != 0,
          "offset_view: the view is aligned")
    return view


def offset_view_case(name, run, inputs, tma, route):
    """Unaligned bf16 views of the TMA operands (positions `tma` of
    `inputs`) through a wgmma route give bitwise the aligned copies' output
    (ops copies such a view before TMA reads it)."""
    want = run(*inputs)
    got = run(*(offset_view(t) if i in tma else t
                for i, t in enumerate(inputs)))
    torch.cuda.synchronize()
    check(route == "wgmma", f"{name} offset view: route {route}, not wgmma")
    check(torch.equal(got, want), f"{name} offset view: the output differs "
          "from the aligned copy's")
    log(f"{name} offset bf16 views (data 2 bytes past 16-byte alignment, "
        f"{route} route): bitwise the aligned copy's output")


def decode_logits(model, params, prompts, tokens, force):
    """Prefill `prompts` through `make_serve_steps(model, force)`, copy the
    cache as `serve` does, then decode the given tokens (B, n) one step at a
    time: the logits of every step, (B, n, Vp)."""
    prefill_step, decode_step = make_serve_steps(model, force)
    B, P = prompts.shape
    _, pre = prefill_step(params, {"tokens": prompts})
    cache = model.cache_template(B, P + tokens.shape[1], dtype=pre["k"].dtype)
    cache["k"][:, :, :P].copy_(pre["k"])
    cache["v"][:, :, :P].copy_(pre["v"])
    del pre
    out = []
    for i in range(tokens.shape[1]):
        pos = torch.full((B,), P + i, dtype=torch.long, device=prompts.device)
        logits, cache = decode_step(params, cache, tokens[:, i:i + 1], pos)
        out.append(logits)
    return torch.stack(out, dim=1)


def phase_cut_depth():
    """gemma2-9b at full width, 4 layers (2 local, 2 global), f32: the
    kernel path against the plain path on the same weights and prompts."""
    cfg = dataclasses.replace(GEMMA2_9B, num_layers=CUT_DEPTH_LAYERS)
    model = Model(cfg, param_dtype=torch.float32)
    params = model.init(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (CUT_DEPTH_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    before = ops.flash_attention.launches
    tok_k, logits_k = serve(model, params, prompts, CUT_DEPTH_GEN)
    torch.cuda.synchronize()
    launches = ops.flash_attention.launches - before
    tok_r, logits_r = serve(model, params, prompts, CUT_DEPTH_GEN,
                            force="ref")
    torch.cuda.synchronize()
    check(launches == CUT_DEPTH_LAYERS,
          f"cut-depth: {launches} flash launches for {CUT_DEPTH_LAYERS} "
          "layers")
    check(bool(torch.isfinite(logits_k).all()), "cut-depth: non-finite")
    torch.testing.assert_close(logits_k, logits_r, rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    check(torch.equal(tok_k, tok_r),
          f"cut-depth: greedy tokens differ\n{tok_k}\n{tok_r}")
    gap = float((logits_k - logits_r).abs().max())
    # The random-weight model's greedy choice repeats one token, so the
    # decode steps are also held by their logits, fed random tokens over
    # the cache that each path's prefill built.
    fed = torch.randint(0, cfg.vocab_size, (CUT_DEPTH_B, CUT_DEPTH_GEN),
                        generator=gen, device="cuda")
    dec_k = decode_logits(model, params, prompts, fed, "auto")
    dec_r = decode_logits(model, params, prompts, fed, "ref")
    check(bool(torch.isfinite(dec_k).all()), "cut-depth: non-finite decode")
    torch.testing.assert_close(dec_k, dec_r, rtol=MODEL_TOL, atol=MODEL_TOL)
    dec_gap = float((dec_k - dec_r).abs().max())
    log(f"cut-depth gemma2-9b ({CUT_DEPTH_LAYERS} layers, full width, f32, "
        f"B={CUT_DEPTH_B}, prompt {SERVE_PROMPT}): kernel vs plain prefill "
        f"logits max gap {gap:.3e}, {CUT_DEPTH_GEN} decode steps' logits "
        f"max gap {dec_gap:.3e} (tol {MODEL_TOL}); {CUT_DEPTH_GEN} greedy "
        f"tokens identical: {tok_k.tolist()}; decode argmax "
        f"{dec_k.argmax(-1).tolist()}")


def phase_serve():
    """The second main path: full-depth bf16 gemma2-9b serving a batch."""
    cfg = GEMMA2_9B
    model = Model(cfg)  # bf16 weights on the card
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    log(f"serve gemma2-9b: {model.param_count()} parameters "
        f"({weight_bytes / 1e9:.3f} GB bf16) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                            generator=gen, device="cuda")
    serve(model, params, prompts[:, :256], 2)  # warm-up: handles, library
    # time to the first token: serve one token, i.e. prefill and cache copy
    ops.flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(model, params, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.flash_attention.launches

    torch.cuda.reset_peak_memory_stats()
    ops.flash_attention.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    tokens, logits = serve(model, params, prompts, SERVE_GEN)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = ops.flash_attention.launches  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    check(prefill_launches == cfg.num_layers,
          f"serve: {prefill_launches} flash launches in the prefill, "
          f"expected {cfg.num_layers}")
    check(launches == prefill_launches,
          f"serve: {launches - prefill_launches} flash launches in decode")
    check(tuple(tokens.shape) == (SERVE_B, SERVE_GEN),
          f"serve: tokens {tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "serve: a token outside the vocabulary")
    check(tuple(logits.shape) == (SERVE_B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "serve: prefill logits not finite or of the wrong shape")
    steps = SERVE_GEN - 1
    decode_s = total_s - prefill_s
    kv_bytes = (2 * cfg.num_layers * SERVE_B * (SERVE_PROMPT + SERVE_GEN)
                * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
    log(f"serve {SERVE_B} x {SERVE_PROMPT} prompt tokens, {SERVE_GEN} "
        f"generated each: prefill {1e3 * prefill_s:.3f} ms "
        f"({SERVE_B * SERVE_PROMPT / prefill_s:.1f} prompt tok/s), "
        f"decode {1e3 * decode_s / steps:.3f} ms/token over {steps} steps "
        f"({SERVE_B * steps / decode_s:.1f} tok/s), end to end "
        f"{SERVE_B * SERVE_GEN / total_s:.1f} generated tok/s")
    log(f"serve flash launches: {prefill_launches} in prefill, "
        f"{launches - prefill_launches} in decode; the prefill's bf16 "
        f"D={cfg.resolved_head_dim} calls take the "
        f"{flash_build.route(torch.bfloat16, cfg.resolved_head_dim)} route")
    log(f"serve peak device memory {peak / 1e9:.3f} GB; weights "
        f"{weight_bytes / 1e9:.3f} GB + KV cache {kv_bytes / 1e9:.3f} GB = "
        f"{(weight_bytes + kv_bytes) / 1e9:.3f} GB")
    log(f"serve sample tokens: {tokens[0, :16].tolist()}")

    # Every layer's attention at the main path's shape and dtype, on the
    # activations the plain path feeds it: the kernel and the bf16-score
    # control against the rounding rule (the plain path goes on unchanged).
    layer_ex = []

    def held(q, k, v, force, **opts):
        out = kernel_wrapper(q, k, v, force=force, **opts)
        layer_ex.append(bf16_excess(
            q, k, v, opts, plain=out,
            kernel=kernel_wrapper(q, k, v, force="cuda", **opts),
            control=attention_bf16_scores(q, k, v, **opts)))
        return out

    with attention_as(held) as kernel_wrapper:
        logits_ref, _ = model.prefill(params, {"tokens": prompts},
                                      force="ref")
    check(len(layer_ex) == cfg.num_layers,
          f"serve: {len(layer_ex)} attention calls held, expected "
          f"{cfg.num_layers}")
    for i, ex in enumerate(layer_ex):
        check_excess(f"serve layer {i}", ex)
    log("serve every layer's attention on the plain path's activations, "
        f"excess over half a bf16 ulp / max|v| (limit {F32_NOISE:.3e}): "
        f"kernel max {max(e['kernel'] for e in layer_ex):.3e}, plain max "
        f"{max(e['plain'] for e in layer_ex):.3e}, bf16-score control min "
        f"{min(e['control'] for e in layer_ex):.3e} / max "
        f"{max(e['control'] for e in layer_ex):.3e}, P-in-bf16 control min "
        f"{min(e['control_p_bf16'] for e in layer_ex):.3e} / max "
        f"{max(e['control_p_bf16'] for e in layer_ex):.3e}")

    # The logits at full depth, against the plain path summed in another
    # order (the floor) and the plain path with bf16 scores (the control).
    with attention_as(lambda q, k, v, force, **opts: kref.attention_ref(
            q, k, v, chunk=256, **opts)):
        logits_floor, _ = model.prefill(params, {"tokens": prompts},
                                        force="ref")
    with attention_as(lambda q, k, v, force, **opts: attention_bf16_scores(
            q, k, v, **opts)):
        logits_ctl, _ = model.prefill(params, {"tokens": prompts},
                                      force="ref")
    gaps = {}
    for name, x in (("kernel", logits), ("floor", logits_floor),
                    ("control", logits_ctl)):
        d = x - logits_ref
        gaps[name] = (float(d.abs().max()), float(d.pow(2).mean().sqrt()))
    ratio = {name: r / gaps["floor"][1] for name, (_, r) in gaps.items()}
    log(f"serve last-prompt-token logits (capped at "
        f"+-{cfg.final_logit_softcap}) against the plain path, max |gap| / "
        f"rms gap / rms over the floor's: "
        + "; ".join(f"{name} {a:.4f} / {r:.5f} / {ratio[name]:.4f}"
                    for name, (a, r) in gaps.items())
        + f" (floor: plain in 256-key chunks; control: bf16 scores; limit "
          f"{RMS_GAP_FACTOR})")
    check(ratio["kernel"] <= RMS_GAP_FACTOR,
          f"serve: rms logit gap {gaps['kernel'][1]} > {RMS_GAP_FACTOR} x "
          f"the summation-order floor {gaps['floor'][1]}")
    return launches, 1e3 * prefill_s


@contextlib.contextmanager
def attention_as(fn):
    """Route the model's attention calls to fn(q, k, v, force, **opts)
    inside the block; yields the wrapper they reach otherwise."""
    orig = mattn.kops
    mattn.kops = types.SimpleNamespace(flash_attention=fn)
    try:
        yield orig.flash_attention
    finally:
        mattn.kops = orig


# ---------------------------------------------------------------------------
# ssd_scan and the mamba2-130m serving path
# ---------------------------------------------------------------------------
def ssd_bound_ms(B, S, H, P, G, N, dtype, chunk=64):
    """Least time for one call: x, dt, B, C read once and y written once
    over the HBM rate, vs the chunked work over the dtype's peak: per
    chunk of q steps C.B^T once per group (q^2 N), and per head W.x over
    j <= i (q(q+1)/2 P) and the two state terms (2 q N P), 2 FLOP each.
    The chunk is fixed at 64, whatever chunk a kernel takes, so the bound
    stays one yardstick across kernel designs."""
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) \
        + 4 * 2 * H  # A and D in f32
    flops = 0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        flops += 2 * (B * G * q * q * N
                      + B * H * (q * (q + 1) // 2 * P + 2 * q * N * P))
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_inputs(B, S, H, P, G, N, decay, gen):
    """x, dt, A, Bm, Cm, D on the card, f32. "mamba2": A = -U[1, 16] and
    dt log-uniform in [1e-3, 1e-1], as Mamba-2 initialises them; "slow":
    A = -U[0.5, 1] and dt log-uniform in [1e-3, 1e-2], so exp(sum dt A)
    over a 64-step chunk stays above 0.5 and the carry dominates."""
    lo, hi, a_lo, a_hi = ((1e-3, 1e-1, 1.0, 16.0) if decay == "mamba2"
                          else (1e-3, 1e-2, 0.5, 1.0))

    def uniform(shape, a, b):
        return torch.rand(shape, generator=gen, device="cuda") * (b - a) + a

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std

    return (normal((B, S, H, P), 0.5),
            torch.exp(uniform((B, S, H), math.log(lo), math.log(hi))),
            -uniform((H,), a_lo, a_hi),
            normal((B, S, G, N), 0.3), normal((B, S, G, N), 0.3),
            1.0 + normal((H,), 0.5))


def ssd_terms(x, dt, A, Bm, Cm, D, **splits):
    """The plain chunked SSD on f32 copies, at the kernel's chunk, as
    (y, y_intra + D x, inter share): the f32 oracle, the control that
    drops the state the kernel carries from chunk to chunk (before
    rounding), and ||y_inter|| / ||y||. `splits` go to
    ``ref.ssd_chunk_terms``: how the f32 operands of the tensor-core
    products are rounded."""
    f = [t.float() for t in (x, dt, A, Bm, Cm)]
    y_intra, y_inter = kref.ssd_chunk_terms(*f, chunk=ssd_build.CHUNK,
                                            **splits)
    dx = D.float()[None, None, :, None] * f[0]
    y = y_intra + y_inter + dx
    share = float(y_inter.norm() / y.norm())
    return y, y_intra + dx, share


# The single-rounding controls: each f32 operand of a tensor-core product
# rounded once to bf16 (``ref.ssd_chunk_terms``'s splits; the wgmma kernel
# takes each as hi + lo). On the CPU each fails the rule by 2-50x
# (tests/test_torch_ssd_split.py).
SSD_ROUNDING_CONTROLS = {"control_w_bf16": dict(w_split=1),
                         "control_state_bf16": dict(state_split=1),
                         "control_update_bf16": dict(update_split=1)}


def ssd_excess(x, dt, A, Bm, Cm, D, **outs):
    """The bf16 rounding rule for SSD outputs (`tol.half_ulp_excess` over
    max|y|), with every control: the carry dropped, and each of W, the
    state as C . state reads it and x_j w_j of the state update rounded
    once to bf16."""
    oracle, dropped, share = ssd_terms(x, dt, A, Bm, Cm, D)
    bf16 = torch.bfloat16
    controls = {name: ssd_terms(x, dt, A, Bm, Cm, D, **splits)[0].to(bf16)
                for name, splits in SSD_ROUNDING_CONTROLS.items()}
    ex = tol.half_ulp_excess(oracle, float(oracle.abs().max()),
                             control_carry=dropped.to(bf16), **controls,
                             **outs)
    return ex, share


def phase_ssd():
    """ssd_scan against its plain version at the mamba2-130m layer shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    B, S, H, P, G, N = SSD_SHAPE
    cases = [
        ("mamba2 layer", (B, S, H, P, G, N), "mamba2"),
        ("slow decay", (B, S, H, P, G, N), "slow"),
        ("unaligned S=1000", (B, 1000, H, P, G, N), "mamba2"),
        ("G=2", (4, S, H, P, 2, N), "mamba2"),
    ]
    max_err = 0.0
    for name, shape, decay in cases:
        x, dt, A, Bm, Cm, D = ssd_inputs(*shape, decay, gen)
        for dtype in (f32, bf16):
            args = [t.to(dtype) for t in (x, dt)] + [A] \
                + [t.to(dtype) for t in (Bm, Cm)] + [D]
            kind = ssd_build.route(dtype, shape[3], shape[5])
            tag = f"ssd {name} {shape} {dtype} {decay} ({kind} route)"
            routes = dict(ops.ssd_scan.route_launches)
            a = ops.ssd_scan(*args, force="cuda")
            b = ops.ssd_scan(*args, force="cuda")
            want = ops.ssd_scan(*args, chunk=256, force="ref")
            torch.cuda.synchronize()
            check(ops.ssd_scan.route_launches[kind] == routes[kind] + 2,
                  f"{tag}: the launches did not take that route ({routes} "
                  f"-> {ops.ssd_scan.route_launches})")
            check(torch.equal(a, b), f"{tag}: two launches differ")
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite output")
            if dtype == bf16:
                ex, share = ssd_excess(*args, kernel=a, plain=want)
                check_excess(tag, ex)
                rule = ("excess over half a bf16 ulp / max|y|: "
                        + ", ".join(f"{k} {v:.3e}" for k, v in ex.items())
                        + f" (limit {F32_NOISE:.3e})")
            else:
                torch.testing.assert_close(a, want, rtol=SSD_F32_TOL,
                                           atol=SSD_F32_TOL)
                oracle, dropped, share = ssd_terms(*args)
                gap = float((dropped - oracle).abs().max())
                check(gap > 10 * SSD_F32_TOL,
                      f"{tag}: dropping the carry moves y by only {gap}")
                rule = (f"tol {SSD_F32_TOL}; the carry-dropping control is "
                        f"{gap:.3e} off")
            err = float((a.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            log(f"{tag}: bitwise across launches, max|kernel-plain| = "
                f"{err:.3e}, ||y_inter||/||y|| = {share:.4f}; {rule}")

    x, dt, A, Bm, Cm, D = ssd_inputs(2, 300, 4, P, G, N, "mamba2", gen)
    offset_view_case("ssd", lambda *t: ops.ssd_scan(*t, force="cuda"),
                     [x.to(bf16), dt.to(bf16), A, Bm.to(bf16), Cm.to(bf16),
                      D], (0, 3, 4), ssd_build.route(bf16, P, N))

    x, dt, A, Bm, Cm, D = ssd_inputs(B, S, H, P, G, N, "mamba2", gen)
    times = {}
    for dtype in (bf16, f32):
        args = [t.to(dtype) for t in (x, dt)] + [A] \
            + [t.to(dtype) for t in (Bm, Cm)] + [D]
        ms = cuda_ms(lambda: ops.ssd_scan(*args, force="cuda"), reps=10,
                     warmup=2)
        plain_ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk=256,
                                                force="ref"),
                           reps=3, warmup=1)
        bound_ms, bound_by = ssd_bound_ms(B, S, H, P, G, N, dtype)
        times[dtype] = (ms, plain_ms, bound_ms, bound_by)
        log(f"ssd mamba2 layer {SSD_SHAPE} {dtype}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}),"
            f" kernel/bound {ms / bound_ms:.1f}x")
    ms, plain_ms, bound_ms, bound_by = times[bf16]
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu",
                replaces="src/repro/kernels/ssd_scan.py:67",
                launches=None, max_abs_err=max_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def mamba2_params(model, seed):
    """Weights from `seed`, with A_log = log U[1, 16] and dt_bias =
    softplus^-1(log-uniform [1e-3, 1e-1]) per layer and head, as Mamba-2
    initialises them: the template's A_log = 1, dt_bias = 0 decay the state
    to 0 within a chunk, so no check could see the carry."""
    params = model.init(seed)
    gen = torch.Generator(device=model.device).manual_seed(seed + 100)
    ssm_p = params["layers"]["ssm"]
    shape = ssm_p["A_log"].shape
    u = torch.rand(shape, generator=gen, device=model.device)
    ssm_p["A_log"].copy_(torch.log(1.0 + 15.0 * u))
    u = torch.rand(shape, generator=gen, device=model.device)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    ssm_p["dt_bias"].copy_(torch.log(torch.expm1(dt0)))
    return params


def gap_stats(a, b):
    """Max and rms of |a - b|, and how many entries break the elementwise
    rtol = atol = MODEL_TOL rule against b."""
    d = (a - b).abs()
    return dict(max=float(d.max()), rms=float(d.pow(2).mean().sqrt()),
                over=int((d > MODEL_TOL + MODEL_TOL * b.abs()).sum()))


def ssd_at_chunk(chunk):
    """The plain version at a fixed chunk length, whatever the model asks:
    the same function summed in another order (the floor)."""
    def fn(x, dt, A, Bm, Cm, D, **_):
        return kref.ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    return fn


def ssd_carry_dropped(x, dt, A, Bm, Cm, D, **_):
    """The control: the SSD with the state between the kernel's chunks
    dropped."""
    _, dropped, _ = ssd_terms(x, dt, A, Bm, Cm, D)
    return dropped.to(x.dtype)


def phase_ssm_f32():
    """Full-depth mamba2-130m in f32. Each layer's SSD, on the plain path's
    activations, within SSD_F32_TOL of its plain version (a carry-dropping
    control must fail that). At the logits, the kernel path's prefill, the
    decode warm-up's last logits (the recurrence) and 8 decode steps fed
    random tokens, against the plain path: their rms gaps within
    FLOOR_FACTOR of the floor, the plain path against itself at the
    kernel's chunk length; the carry-dropping control outside it."""
    cfg = MAMBA2_130M
    B, P, n = SSM_F32_B, SSM_F32_PROMPT, SSM_F32_FED
    model = Model(cfg, param_dtype=torch.float32)
    params = mamba2_params(model, SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # the prompt, the fed tokens, and more, so the scan over all of them
    # keeps the reference's S % chunk == 0
    toks = torch.randint(0, cfg.vocab_size, (B, P + cfg.ssm_chunk),
                         generator=gen, device="cuda")
    batch = {"tokens": toks[:, :P]}
    before = ops.ssd_scan.launches
    core = ops.ssd_scan.route_launches["cuda-core"]
    logits_k, _ = model.prefill(params, batch)
    torch.cuda.synchronize()
    launches = ops.ssd_scan.launches - before
    check(launches == cfg.num_layers
          and ops.ssd_scan.route_launches["cuda-core"] - core == launches,
          f"mamba2 f32: {launches} ssd launches in a {cfg.num_layers}-layer "
          "prefill, not all on the cuda-core route")

    layers = []

    def held(x, dt, A, Bm, Cm, D, chunk, force):
        out = kernel_wrapper(x, dt, A, Bm, Cm, D, chunk=chunk, force=force)
        k = kernel_wrapper(x, dt, A, Bm, Cm, D, force="cuda")
        dropped = ssd_carry_dropped(x, dt, A, Bm, Cm, D)
        torch.testing.assert_close(k, out, rtol=SSD_F32_TOL, atol=SSD_F32_TOL)
        over = (dropped - out).abs() - (SSD_F32_TOL + SSD_F32_TOL * out.abs())
        check(float(over.max()) > 0, f"mamba2 f32 layer {len(layers)}: the "
              "carry-dropping control passes the f32 tolerance")
        layers.append((float((k - out).abs().max()),
                       float((dropped - out).abs().max())))
        return out

    with ssd_as(held) as kernel_wrapper:
        logits_r, _ = model.prefill(params, batch, force="ref")
    check(len(layers) == cfg.num_layers,
          f"mamba2 f32: {len(layers)} ssd calls held")
    log(f"mamba2-130m f32 every layer's SSD on the plain path's activations "
        f"(B={B}, prompt {P}): max|kernel-plain| "
        f"{max(k for k, _ in layers):.3e} (tol {SSD_F32_TOL}); the "
        f"carry-dropping control min {min(c for _, c in layers):.3e} off")

    with ssd_as(ssd_at_chunk(ssd_build.CHUNK)):
        logits_f, _ = model.prefill(params, batch, force="ref")
        scan_f, _ = transformer.forward(params, toks, cfg, force="ref")
    with ssd_as(ssd_carry_dropped):
        logits_c, _ = model.prefill(params, batch, force="ref")
    warm, cache = warm_up(model, params, toks[:, :P],
                          model.cache_template(B, P + n))
    dec = []
    for i in range(P, P + n):
        pos = torch.full((B,), i, dtype=torch.long, device="cuda")
        logits, cache = model.decode(params, cache, toks[:, i:i + 1], pos)
        dec.append(logits)
    dec = torch.stack(dec, dim=1)
    scan_k, _ = transformer.forward(params, toks, cfg)
    scan_r, _ = transformer.forward(params, toks, cfg, force="ref")
    at = slice(P, P + n)
    torch.cuda.synchronize()
    for name, x in (("kernel", logits_k), ("plain", logits_r), ("warm", warm),
                    ("decode", dec), ("scan", scan_k)):
        check(bool(torch.isfinite(x).all()), f"mamba2 f32: {name} non-finite")
    prefill = {"kernel path": gap_stats(logits_k, logits_r),
               "decode warm-up (recurrence)": gap_stats(warm, logits_r),
               "floor: plain at chunk 64": gap_stats(logits_f, logits_r),
               "control: carry dropped": gap_stats(logits_c, logits_r)}
    steps = {"kernel path's scan": gap_stats(scan_k[:, at], scan_r[:, at]),
             f"{n} decode steps (recurrence)": gap_stats(dec, scan_r[:, at]),
             "floor: plain at chunk 64": gap_stats(scan_f[:, at],
                                                   scan_r[:, at])}
    for where, gaps in (("prefill last-token logits", prefill),
                        (f"logits at the {n} fed positions", steps)):
        floor = gaps["floor: plain at chunk 64"]["rms"]
        log(f"mamba2-130m f32 {where} against the plain path (chunk "
            f"{cfg.ssm_chunk}), max / rms / entries over rtol=atol="
            f"{MODEL_TOL} / rms over the floor's: "
            + "; ".join(f"{k} {g['max']:.3e} / {g['rms']:.3e} / {g['over']} "
                        f"/ {g['rms'] / floor:.3f}" for k, g in gaps.items())
            + f" (limit {FLOOR_FACTOR} x the floor's rms; logits max|.| "
              f"{float(logits_r.abs().max()):.2f})")
        for k, g in gaps.items():
            if k.startswith("floor"):
                continue
            if k.startswith("control"):
                check(g["rms"] > FLOOR_FACTOR * floor,
                      f"mamba2 f32 {where}: the {k} control is within "
                      f"{FLOOR_FACTOR} x the floor ({g}, floor {floor})")
            else:
                check(g["rms"] <= FLOOR_FACTOR * floor,
                      f"mamba2 f32 {where}: {k} rms gap {g['rms']} > "
                      f"{FLOOR_FACTOR} x the floor {floor}")
    log(f"mamba2-130m f32 decode argmax {dec.argmax(-1).tolist()}")


@contextlib.contextmanager
def ssd_as(fn):
    """Route the model's SSD calls to fn(x, dt, A, Bm, Cm, D, chunk=...,
    force=...) inside the block; yields the wrapper they reach otherwise."""
    orig = mssm.kops
    mssm.kops = types.SimpleNamespace(ssd_scan=fn)
    try:
        yield orig.ssd_scan
    finally:
        mssm.kops = orig


def phase_ssm_serve():
    """The third main path: full-depth bf16 mamba2-130m serving a batch."""
    cfg = MAMBA2_130M
    B, P, n = SSM_SERVE_B, SSM_SERVE_PROMPT, SSM_SERVE_GEN
    model = Model(cfg)  # bf16 weights on the card
    params = mamba2_params(model, SEED)
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device="cuda")
    serve(model, params, prompts[:, :256], 2)  # warm-up: handles, library
    # time to the first token: serve one token, i.e. the prefill
    ops.ssd_scan.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, _ = serve(model, params, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = ops.ssd_scan.launches
    # the decode warm-up over the prompt, then the greedy decode steps
    # from its cache, each timed alone as serve runs them
    t0 = time.perf_counter()
    _, cache = warm_up(model, params, prompts, model.cache_template(B, P + n))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _, decode_step = make_serve_steps(model)
    tok = first[:, 0]
    t0 = time.perf_counter()
    for i in range(n - 1):
        pos = torch.full((B,), P + i, dtype=torch.long, device="cuda")
        step_logits, cache = decode_step(params, cache, tok[:, None], pos)
        tok = step_logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache

    torch.cuda.reset_peak_memory_stats()
    ops.ssd_scan.launches = 0  # the main path starts here
    for kind in ops.ssd_scan.route_launches:
        ops.ssd_scan.route_launches[kind] = 0
    t0 = time.perf_counter()
    tokens, logits = serve(model, params, prompts, n)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = ops.ssd_scan.launches  # ... and ends here
    by_route = dict(ops.ssd_scan.route_launches)
    peak = torch.cuda.max_memory_allocated()

    check(prefill_launches == cfg.num_layers,
          f"mamba2 serve: {prefill_launches} ssd launches in the prefill, "
          f"expected {cfg.num_layers}")
    check(launches == prefill_launches,
          f"mamba2 serve: {launches - prefill_launches} ssd launches in the "
          "warm-up and decode")
    check(by_route["wgmma"] == launches == cfg.num_layers,
          f"mamba2 serve: ssd launches by route {by_route}, expected all "
          f"{cfg.num_layers} on the wgmma route")
    check(tuple(tokens.shape) == (B, n), f"mamba2 serve: tokens "
          f"{tuple(tokens.shape)}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "mamba2 serve: a token outside the vocabulary")
    check(tuple(logits.shape) == (B, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          "mamba2 serve: prefill logits not finite or of the wrong shape")
    steps = n - 1
    log(f"mamba2 serve {B} x {P} prompt tokens, {n} generated each: prefill "
        f"{1e3 * prefill_s:.3f} ms ({B * P / prefill_s:.1f} prompt tok/s), "
        f"decode warm-up over the prompt {1e3 * warm_s:.3f} ms "
        f"({1e3 * warm_s / P:.3f} ms a position), decode "
        f"{1e3 * decode_s / steps:.3f} ms/token over {steps} steps; serve "
        f"end to end {1e3 * total_s:.3f} ms, {B * n / total_s:.1f} generated "
        "tok/s")
    log(f"mamba2 serve ssd launches: {prefill_launches} in the prefill, "
        f"{launches - prefill_launches} in the warm-up and decode; by route "
        f"{by_route}")
    log(f"mamba2 serve peak device memory {peak / 1e9:.3f} GB; weights "
        f"{weight_bytes / 1e9:.3f} GB bf16")
    log(f"mamba2 serve sample tokens: {tokens[0, :16].tolist()}")

    # Every layer's SSD at the main path's shape and dtype, on the
    # activations the plain path feeds it: the kernel and every control
    # against the rounding rule (the plain path goes on unchanged).
    layer_ex = []

    def held(x, dt, A, Bm, Cm, D, chunk, force):
        out = kernel_wrapper(x, dt, A, Bm, Cm, D, chunk=chunk, force=force)
        ex, share = ssd_excess(
            x, dt, A, Bm, Cm, D, plain=out,
            kernel=kernel_wrapper(x, dt, A, Bm, Cm, D, force="cuda"))
        layer_ex.append((ex, share))
        return out

    with ssd_as(held) as kernel_wrapper:
        model.prefill(params, {"tokens": prompts}, force="ref")
    check(len(layer_ex) == cfg.num_layers,
          f"mamba2 serve: {len(layer_ex)} ssd calls held, expected "
          f"{cfg.num_layers}")
    for i, (ex, _) in enumerate(layer_ex):
        check_excess(f"mamba2 serve layer {i}", ex)
    names = layer_ex[0][0].keys()
    log("mamba2 serve every layer's SSD on the plain path's activations, "
        f"excess over half a bf16 ulp / max|y| (limit {F32_NOISE:.3e}): "
        + "; ".join(f"{k} min {min(e[k] for e, _ in layer_ex):.3e} max "
                    f"{max(e[k] for e, _ in layer_ex):.3e}" for k in names)
        + "; ||y_inter||/||y|| min "
          f"{min(s for _, s in layer_ex):.4f} max "
          f"{max(s for _, s in layer_ex):.4f}")
    return launches, 1e3 * prefill_s


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
    libs = kbuild.build_all([kernel_build.SOURCE, *flash_build.SOURCES,
                             *ssd_build.SOURCES])
    log(f"built {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, together)")
    for lib in libs:
        for line in kbuild.compiler_report(lib):
            log(f"  nvcc {lib.name}: {line}")

    record = phase_kernel()
    phase_small()
    cfg = TABLE1_250K_18K
    X, y, w, launches, ms_c = phase_table1(cfg)
    record["launches"] = launches
    log(f"table1 kernel share of a cuda-backend iteration: "
        f"{record['ms']:.4f} / {ms_c:.3f} ms = {record['ms'] / ms_c:.4%}")
    phase_breakdown(cfg, X, y, w)
    del X, y, w  # free the 18 GB before the next phase
    torch.cuda.empty_cache()

    X, y = phase_tiled_plane(cfg)
    phase_radisa_kernel()
    phase_radisa_async(cfg, X, y)
    phase_resumable(cfg, X, y)
    phase_elastic(cfg, X, y)
    ms_static = phase_streaming_anchor(cfg, X, y)
    mesh_refs = phase_mesh_refs(cfg, X, y)
    elastic_refs = phase_mesh_elastic_refs(cfg, X, y)
    del X, y  # free the 18 GB before the mesh, streaming and serving phases
    torch.cuda.empty_cache()
    phase_mesh(cfg, mesh_refs)
    phase_nccl()
    phase_mesh_elastic_streaming(cfg, elastic_refs)
    phase_streaming(cfg, ms_static)

    flash_record, times = phase_flash()
    phase_cut_depth()
    torch.cuda.empty_cache()
    flash_record["launches"], prefill_ms = phase_serve()
    n_local = GEMMA2_9B.num_layers // 2
    kernel_ms = n_local * (times["local"][0] + times["global"][0])
    log(f"serve flash kernel share of the prefill: {n_local} x "
        f"({times['local'][0]:.4f} + {times['global'][0]:.4f}) ms = "
        f"{kernel_ms:.3f} / {prefill_ms:.3f} ms = "
        f"{kernel_ms / prefill_ms:.2%}")

    torch.cuda.empty_cache()
    ssd_record = phase_ssd()
    phase_ssm_f32()
    torch.cuda.empty_cache()
    ssd_record["launches"], ssm_prefill_ms = phase_ssm_serve()
    ssd_ms = MAMBA2_130M.num_layers * ssd_record["ms"]
    log(f"mamba2 serve ssd kernel share of the prefill: "
        f"{MAMBA2_130M.num_layers} x {ssd_record['ms']:.4f} ms = "
        f"{ssd_ms:.3f} / {ssm_prefill_ms:.3f} ms = "
        f"{ssd_ms / ssm_prefill_ms:.2%}")

    print(card)
    print(json.dumps({"kernels": [record, flash_record, ssd_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
