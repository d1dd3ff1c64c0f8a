#!/usr/bin/env python3
"""Where a head's time goes inside the SSD scan's backward kernel, on the card.

    python3 tools/ssd_bwd_phases.py

Copies ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` into
``build/ssd_bwd_phases/`` with ``clock64()`` marks added between the
phases of one head in the per-chunk kernel's consumer warps (the wait for
the head's rows; their split into bf16 tiles and the dt scan; the dW^T
product; W^T, dG^T and the sums of M; the W^T dy product; the barrier
before dG^T is read; per n tile, S0's split and the S0^T dy^T product, the
C . dC_inter sums and dC's sum, dS's split with the dS^T x^T product and
dB's sum, the B^T dG^T and C^T dG products with their sums; the raw^T
products; the du sums and a barrier; the raw term of dx, the dcum scan
and a barrier; dx's rounding and store), builds it with the port's nvcc
flags, runs it at mamba2-130m's training layer (8, 2048, 24, 64, 1, 128)
in f32 and bf16 and prints the mean cycles of each phase a head and warp.
It then times the instrumented and the committed kernel with CUDA events,
each launch's three kernels apart with ``torch.profiler``, and checks that
both builds give the same bits. The phases sum to a head's time. Fails if
the source no longer has the lines it marks. Needs a CUDA device and nvcc;
imports nothing of JAX.
"""
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402

SHAPE = (8, 2048, 24, 64, 1, 128)  # (B, S, H, P, G, N): a training layer
OUT = ROOT / "build" / "ssd_bwd_phases"
PHASES = ["wait for the head's rows", "x, dy to pieces + dt scan",
          "dW^T product", "W^T, dG^T, sums of M", "W^T dy product",
          "barrier, dx tile", "S0 split + S0^T dy^T", "q + dC sum",
          "dS split, de, dS^T x^T + dB sum", "B^T dG^T, C^T dG + sums",
          "raw^T products", "du sums + barrier",
          "raw term + dcum scan + barrier", "dx store"]

HEAD = """
__device__ unsigned long long g_phase[16];
#define PSTART unsigned long long _pt = clock64();
#define PMARK(k) { unsigned long long _n = clock64(); _acc[k] += _n - _pt; _pt = _n; }
"""
TAIL = """
extern "C" int ssd_bwd_phases_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int ssd_bwd_phases_zero() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""


def instrument(src: str) -> str:
    """The source with the phase marks; raises if an anchor is missing."""
    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"ssd_bwd_phases: the source no longer has "
                             f"exactly one {anchor.strip()[:60]!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n\nconstexpr int kQ", HEAD, after=False)
    put("  for (int hi = 0; hi < rep; ++hi) {\n",
        "  unsigned long long _acc[14] = {0,0,0,0,0,0,0,0,0,0,0,0,0,0};\n",
        after=False)
    wait = "    mbar_wait(full, (2 + hi) & 1);\n    consumer_sync();\n"
    put(wait, "    PSTART\n", after=False)
    put(wait, "    PMARK(0)\n")
    put("    if (ct == 0) mbar_arrive(empty);  // the producer loads the next "
        "head\n", "    PMARK(1)\n")
    put("      // acc[4jj + 2ii + cc] is row j = r0 + 8ii, column i = h0",
        "      PMARK(2)\n", after=False)
    put("      // W^T dy over this half's i (rows j, columns p)",
        "      PMARK(3)\n", after=False)
    put("      fence_regs<P / 2>(dxa);\n    }\n", "    PMARK(4)\n")
    put("    // 4. Per n tile", "    PMARK(5)\n", after=False)
    put("      // C_i . dC_inter_i over this warp's rows n", "      PMARK(6)\n",
        after=False)
    put("      // dS at the same places, split, and the thread's share of de",
        "      PMARK(7)\n", after=False)
    put("      // B^T dG^T (rows n, this half's columns i", "      PMARK(8)\n",
        after=False)
    put("      asm volatile(\"\" ::: \"memory\");  // no tile's loads hoisted",
        "      PMARK(9)\n", after=False)
    put("    // rawa[4jj + 2ii + cc] is row p = r0 + 8ii, column j = h0",
        "    PMARK(10)\n", after=False)
    put("    consumer_sync();  // the other half's W^T dy is in the tile; "
        "every sum is written\n", "    PMARK(11)\n")
    put("    consumer_sync();  // the dx tile is whole\n", "    PMARK(12)\n")
    put("      dst[1] = from_float<T>(v[1]);\n    }\n", "    PMARK(13)\n"
        "    if (lane == 0)\n      for (int k = 0; k < 14; ++k) "
        "atomicAdd(&g_phase[k], _acc[k]);\n"
        "    for (int k = 0; k < 14; ++k) _acc[k] = 0;\n")
    return src + TAIL


def cuda_ms(fn, reps=10, warmup=2):
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


def inputs(dtype, gen):
    """Mamba-2's draws (A = -U[1, 16], dt log-uniform in [1e-3, 1e-1]) at
    SHAPE, contiguous on the card in `dtype` (A, D f32)."""
    B, S, H, P, G, N = SHAPE
    x = torch.randn(B, S, H, P, generator=gen, device="cuda") * 0.5
    dt = torch.exp(torch.rand(B, S, H, generator=gen, device="cuda")
                   * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    A = -(torch.rand(H, generator=gen, device="cuda") * 15.0 + 1.0)
    Bm = torch.randn(B, S, G, N, generator=gen, device="cuda") * 0.3
    Cm = torch.randn(B, S, G, N, generator=gen, device="cuda") * 0.3
    D = 1.0 + torch.randn(H, generator=gen, device="cuda") * 0.5
    dy = torch.randn(B, S, H, P, generator=gen, device="cuda")
    return ([t.to(dtype) for t in (x, dt)] + [A]
            + [t.to(dtype) for t in (Bm, Cm)] + [D, dy.to(dtype)])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssd_bwd_phases: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_scan_bwd_phases.cu"
    src.write_text(instrument(ssd_build.BWD_SOURCE.read_text()))
    lib_path = OUT / "libssd_scan_bwd_phases.so"
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.ssd_scan_bwd
    fn.argtypes = [vp] * 18 + [ci] * 7 + [vp, vp]
    fn.restype = ci
    lib.ssd_bwd_phases_read.argtypes = [vp]
    lib.ssd_bwd_phases_read.restype = ci
    lib.ssd_bwd_phases_zero.restype = ci

    B, S, H, P, G, N = SHAPE
    NC = -(-S // 64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"card: {card}; shape (B, S, H, P, G, N) = {SHAPE}")
    for dtype in (torch.float32, torch.bfloat16):
        args = inputs(dtype, gen)
        x, dt, A, Bm, Cm, D, dy = args

        def empty(*shape, dt_=torch.float32):
            return torch.empty(shape, dtype=dt_, device="cuda")

        outs = (empty(B, S, H, P, dt_=dtype), empty(B, S, H, dt_=dtype),
                empty(H), empty(B, S, G, N, dt_=dtype),
                empty(B, S, G, N, dt_=dtype), empty(H))
        scratch = (empty(B, H, NC, P, N), empty(B, H, NC, P, N),
                   empty(B, NC, H), empty(B, NC, H),
                   empty(*ssd_build.bwd_sums_shape(B, S, G, N)))
        strides = (ctypes.c_longlong * 3)(*dt.stride())

        def marked():
            rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                    Cm.data_ptr(), D.data_ptr(), dy.data_ptr(),
                    *(t.data_ptr() for t in outs),
                    *(t.data_ptr() for t in scratch), B, S, H, G, P, N,
                    ssd_build.DTYPE_CODES[dtype], ctypes.cast(strides, vp),
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"ssd_bwd_phases: launch failed ({rc})")

        marked()
        torch.cuda.synchronize()
        lib.ssd_bwd_phases_zero()
        marked()
        torch.cuda.synchronize()
        cyc = (ctypes.c_ulonglong * 16)()
        lib.ssd_bwd_phases_read(ctypes.cast(cyc, vp))
        per = NC * G * B * (H // G) * 8  # heads x consumer warps
        total = sum(cyc[k] for k in range(len(PHASES)))
        name = str(dtype).replace("torch.", "")
        print(f"{name}: cycles a head and consumer warp, mean over "
              f"{per} (chunk kernel)")
        for k, phase in enumerate(PHASES):
            print(f"  {phase:34s} {cyc[k] / per:10.1f}  "
                  f"{cyc[k] / total:6.1%}")
        print(f"  {'a head':34s} {total / per:10.1f}")
        want = ops.ssd_scan_bwd(*args, force="cuda")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs, want))
        ms_marked = cuda_ms(marked)
        ms_plain = cuda_ms(lambda: ops.ssd_scan_bwd(*args, force="cuda"))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ops.ssd_scan_bwd(*args, force="cuda")
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            for kernel in ("ssd_bwd_sweep", "ssd_bwd_chunk",
                           "ssd_bwd_reduce_heads"):
                if kernel in e.key:
                    parts[kernel] = e.self_device_time_total / 3 / 1e3
        print(f"{name}: instrumented {ms_marked:.4f} ms, committed "
              f"{ms_plain:.4f} ms a launch; outputs "
              f"{'bitwise equal' if same else 'DIFFER'}; by kernel (ms, "
              "torch.profiler): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()))
        if not same:
            raise SystemExit("ssd_bwd_phases: the marks changed the result")


if __name__ == "__main__":
    main()
