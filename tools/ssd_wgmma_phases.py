#!/usr/bin/env python3
"""Where a chunk's time goes inside the bf16 SSD-scan kernel, on the card.

    python3 tools/ssd_wgmma_phases.py

Copies ``src/repro_torch/kernels/csrc/ssd_scan_wgmma.cu`` into
``build/ssd_phases/`` with ``clock64()`` marks added between the phases of
a chunk (consumer warps: the wait for the stage, the scan, the update's
operand, the issue of the three products, the wait for C.B^T, W, the
issue of W.x, the wait for all, the epilogue, the state tiles; the
producer warp: the wait for a free stage, the loads), builds it with the
port's nvcc flags, runs it once at the mamba2-130m layer shape
(16, 2048, 24, 64, 1, 128) in bf16 and prints the mean cycles of each
phase per chunk and warp. It then times the instrumented and the
committed kernel with CUDA events and checks that both give the same
bits. The marks cost a few percent; the phases they split sum to the
chunk's time. Fails if the source no longer has the lines it marks.
Needs a CUDA device and nvcc; imports nothing of JAX.
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
from repro_torch.kernels import ssd_scan as ssd_build  # noqa: E402

SHAPE = (16, 2048, 24, 64, 1, 128)  # (B, S, H, P, G, N): a serving layer
OUT = ROOT / "build" / "ssd_phases"
CONSUMER = ["wait for the stage", "scan", "update operand + state scale",
            "issue C.B^T, C.state^T, update", "wait for C.B^T", "W",
            "wait for C.state^T + issue W.x", "wait for all", "epilogue",
            "state tiles"]
PRODUCER = {10: "wait for a free stage", 11: "dt loads + TMA issue"}

HEAD = """
__device__ unsigned long long g_phase[16];
#define PSTART unsigned long long _pt = clock64();
#define PMARK(k) { unsigned long long _n = clock64(); _acc[k] += _n - _pt; _pt = _n; }
"""
TAIL = """
extern "C" int ssd_phases_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
"""
ZERO = "    unsigned long long _acc[12] = {0,0,0,0,0,0,0,0,0,0,0,0};\n"


def instrument(src: str) -> str:
    """The source with the phase marks; raises if an anchor is missing."""
    def put(anchor, text, after=True):
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"ssd_wgmma_phases: the source no longer has "
                             f"exactly one {anchor.strip()!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n\nconstexpr int kQ", HEAD, after=False)
    put("    store_state();  // the state carried into chunk 0 is 0\n", ZERO)
    wait_full = "      mbar_wait(full + 8 * stage, (it / kStages) & 1);\n"
    put(wait_full, "      PSTART\n", after=False)
    put(wait_full, "      PMARK(0)\n")
    put("      const float cum_r[2] = {cum_s[r0], cum_s[r0 + 8]};\n",
        "      PMARK(1)\n", after=False)
    put("      for (int i = 0; i < N / 2; ++i) state[i] *= elast;\n",
        "      PMARK(2)\n")
    put("      // 4. W from G's accumulator", "      PMARK(3)\n", after=False)
    put("      wgmma_wait<2>();\n      fence_regs(gacc);\n", "      PMARK(4)\n")
    put("      // 5. y's rows times exp(cum_i)", "      PMARK(5)\n",
        after=False)
    put("      wgmma_wait<0>();\n      fence_regs(y);\n", "      PMARK(6)\n",
        after=False)
    put("      fence_regs(y);\n      fence_regs(state);\n", "      PMARK(7)\n")
    put("      if (lane == 0) mbar_arrive(empty + 8 * stage);", "\n      PMARK(8)")
    put("        warpgroup_sync(1 + wg);\n        store_state();\n      }\n",
        "      PMARK(9)\n")
    put("      PMARK(9)\n    }\n",
        "    if (lane == 0)\n      for (int k = 0; k < 10; ++k) "
        "atomicAdd(&g_phase[k], _acc[k]);\n")
    put("      const int lane = threadIdx.x;\n", ZERO.replace("    ", "      "))
    empty_wait = ("        mbar_wait(empty + 8 * stage, (use & 1) ^ 1);  "
                  "// the first use passes\n")
    put("        // dt of both heads, steps c0 + lane", "        PSTART\n",
        after=False)
    put(empty_wait, "        PMARK(11)\n", after=False)
    put(empty_wait, "        PMARK(10)\n")
    put("        mbar_arrive(bar);  // releases this lane's dt writes\n",
        "        PMARK(11)\n")
    put("        PMARK(11)\n      }\n",
        "      if (lane == 0) {\n        atomicAdd(&g_phase[10], _acc[10]);\n"
        "        atomicAdd(&g_phase[11], _acc[11]);\n      }\n")
    return src + TAIL


def cuda_ms(fn, reps=20, warmup=3):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ssd_wgmma_phases: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "ssd_scan_wgmma_phases.cu"
    src.write_text(instrument(ssd_build.WGMMA_SOURCE.read_text()))
    lib_path = OUT / "libssd_scan_wgmma_phases.so"
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fwd = lib.ssd_scan_wgmma_fwd
    fwd.argtypes = [vp] * 7 + [ci] * 6 + [vp, vp]
    fwd.restype = ci
    lib.ssd_phases_read.argtypes = [vp]
    lib.ssd_phases_read.restype = ci

    B, S, H, P, G, N = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    x = (torch.randn(B, S, H, P, generator=gen, device="cuda") * 0.5).to(bf16)
    dt = torch.exp(torch.rand(B, S, H, generator=gen, device="cuda")
                   * (math.log(1e-1) - math.log(1e-3))
                   + math.log(1e-3)).to(bf16)
    A = -(torch.rand(H, generator=gen, device="cuda") * 15.0 + 1.0)
    Bm = (torch.randn(B, S, G, N, generator=gen, device="cuda") * 0.3).to(bf16)
    Cm = (torch.randn(B, S, G, N, generator=gen, device="cuda") * 0.3).to(bf16)
    D = 1.0 + torch.randn(H, generator=gen, device="cuda") * 0.5
    out = torch.empty_like(x)
    strides = (ctypes.c_longlong * 3)(*dt.stride())

    def marked():
        rc = fwd(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), D.data_ptr(), out.data_ptr(), B, S, H, G, P,
                 N, ctypes.cast(strides, vp),
                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise SystemExit(f"ssd_wgmma_phases: launch failed ({rc})")

    marked()
    torch.cuda.synchronize()
    sums = (ctypes.c_ulonglong * 16)()
    lib.ssd_phases_read(sums)
    want = ssd_build.ssd_scan_cuda(x, dt, A, Bm, Cm, D)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise SystemExit("ssd_wgmma_phases: the instrumented kernel gives "
                         "other bits than the committed one")
    heads_per_block = ssd_build.HEADS_PER_BLOCK
    blocks = B * G * -(-(H // G) // heads_per_block)
    chunks = -(-S // ssd_build.CHUNK)
    per_warp = [sums[k] / (4 * heads_per_block * blocks * chunks)
                for k in range(len(CONSUMER))]
    print(f"card: {card}")
    print(f"ssd wgmma phases at {SHAPE} bf16, mean cycles per chunk and "
          "consumer warp:")
    for name, c in zip(CONSUMER, per_warp):
        print(f"  {name:34s} {c:9.1f}  ({c / sum(per_warp):6.2%})")
    print(f"  {'sum':34s} {sum(per_warp):9.1f}")
    print("producer warp, mean cycles per chunk: "
          + ", ".join(f"{name} {sums[k] / (blocks * chunks):.1f}"
                      for k, name in PRODUCER.items()))
    base_ms = cuda_ms(lambda: ssd_build.ssd_scan_cuda(x, dt, A, Bm, Cm, D))
    marked_ms = cuda_ms(marked)
    print(f"kernel {base_ms:.4f} ms, instrumented {marked_ms:.4f} ms; "
          f"{blocks} blocks of {chunks} chunks")


if __name__ == "__main__":
    main()
