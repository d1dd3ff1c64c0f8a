#!/usr/bin/env python3
"""Where an item's time goes inside flash attention's backward kernel, on the card.

    python3 tools/flash_bwd_phases.py [--layer gemma2-global|zamba2]

Copies ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` (and the
``sm90.cuh`` header beside it) into ``build/flash_bwd_phases/`` with
``clock64()`` marks added between the phases of one item (a query tile in
the dK/dV kernel, a key tile in the dQ kernel) in the consumer warps: the
wait for the item's tiles (TMA), the f32 split of the streamed tiles into
bf16 pieces (with its two consumer barriers; nothing for bf16), the S / dP
product, the waits at the hand-over of the scores between the two
consumer warpgroups, the softmax / dS elementwise work, the dV / dK / dQ
products (with the split of P or dS into pieces and the f32 adds), and,
once a block, the gradient's store. It builds the copy with the port's nvcc
flags, runs it at gemma2-9b's global training layer (1, 16, 8, 4608, 4608,
256; causal, softcap 50; the default) or zamba2-7b's (1, 32, 32, 4608,
4608, 112; causal) in f32 and bf16, and prints the mean cycles of
each phase an item and consumer warp, for each warpgroup role and kernel.
It then times the instrumented and the committed kernel with CUDA events,
each launch's three kernels apart with ``torch.profiler``, and checks that
both builds give the same bits. Fails if the source no longer has the lines
it marks. Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (B, H, KV, Sq, Sk, D) and options of each layer the tool can run
LAYERS = {"gemma2-global": ((1, 16, 8, 4608, 4608, 256),
                            dict(causal=True, softcap=50.0)),
          "zamba2": ((1, 32, 32, 4608, 4608, 112), dict(causal=True))}
OUT = ROOT / "build" / "flash_bwd_phases"
PHASES = ["wait for the item's tiles (TMA)", "f32 split into pieces",
          "S / dP product", "hand-over waits", "softmax / dS elementwise",
          "dV / dK / dQ products", "store (once a block)"]
KERNELS = ("flash_bwd_dkdv", "flash_bwd_dq")
ROLES = {"flash_bwd_dkdv": ("S^T, P, dV", "dP^T, dS, dK"),
         "flash_bwd_dq": ("S, dS, dQ (bf16: of the first half of a key "
                          "tile)", "dP (bf16: and dS, dQ of the second half)")}

HEAD = """
__device__ unsigned long long g_phase[2][2][8];  // kernel, warpgroup, phase
#define PMARK(k) { const unsigned long long _n = clock64(); _acc[k] += _n - _pt; _pt = _n; }
#define PFLUSH(kid) if (lane == 0) for (int _k = 0; _k < 8; ++_k) atomicAdd(&g_phase[kid][wg][_k], _acc[_k]);
"""
TAIL = """
extern "C" int flash_bwd_phases_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int flash_bwd_phases_zero() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
"""


def instrument(src: str) -> str:
    """The source with the phase marks; raises if an anchor is missing."""
    def put(anchor, text, after=True, count=1):
        nonlocal src
        if src.count(anchor) != count:
            raise SystemExit(f"flash_bwd_phases: the source no longer has "
                             f"{count} of {anchor.strip()[:60]!r}")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    put("namespace {\n\nconstexpr int kRows", HEAD, after=False)
    put("  if (n_items > 0) mbar_wait(sm.res_full(), 0);\n",
        "  unsigned long long _acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, _pt = 0;\n",
        after=False, count=2)
    wait = ("    mbar_wait(sm.full(s), (it / C::kRing) & 1);  // the item's "
            "tiles are in\n")
    put(wait, "    _pt = clock64();\n", after=False, count=2)
    put(wait, "    PMARK(0)\n    _acc[7] += 1;\n", count=2)
    put("      if (issuer && it + 1 < n_items) load_item(it + 1);  // the slot "
        "is free\n    }\n", "    PMARK(1)\n", count=2)
    put("                        sm.stream(s, wg));\n", "    PMARK(2)\n",
        count=2)
    # dkdv
    put("      if (it > 0) bar_sync(kBarFree, kThreads);  // wg 1 has read "
        "the last\n", "      PMARK(3)\n")
    put("      bar_arrive(kBarReady, kThreads);  // P's scores are handed "
        "over\n", "      PMARK(4)\n")
    put("      bar_sync(kBarReady, kThreads);  // wg 0's scores are in\n",
        "      PMARK(3)\n")
    put("    // dV += P^T . dO (wg 0) or dK += dS^T . Q (wg 1)\n",
        "    PMARK(4)\n", after=False)
    put("    grad_product<T, L>(grad, frag, sm.stream(s, 1 - wg));\n",
        "    PMARK(5)\n")
    store = ("  store_grad<T, L>(grad, wg == 0 ? 1.0f : scale, wg == 0 ? dv "
             ": dk, b, Sk, KV,\n                   kvh, k0, DT, warp, lane);\n")
    put(store, "  _pt = clock64();\n", after=False)
    put(store, "  PMARK(6)\n  PFLUSH(0)\n")
    # dq
    put("      if (it > 0) bar_sync(kBarFree, kThreads);  // wg 0 has read "
        "the last\n", "      PMARK(3)\n")
    put("      bar_arrive(kBarReady, kThreads);  // dP is handed over\n",
        "      PMARK(4)\n")
    put("      bar_sync(kBarReady, kThreads);  // wg 1's dP is in\n",
        "      PMARK(3)\n")
    put("      // dQ += dS . K\n", "      PMARK(4)\n", after=False)
    put("      grad_product<T, L>(grad, frag, sm.stream(s, 0));\n",
        "      PMARK(5)\n")
    # dq, the key tile split between the warpgroups
    put("      bar_sync(kBarReady, kThreads);  // both halves are handed "
        "over\n", "      PMARK(3)\n")
    put("      // dQ_partial += dS . K over this warpgroup's keys\n",
        "      PMARK(4)\n", after=False)
    put("      grad_product<T, L, BN / 32>(grad, frag, sm.stream(s, 0), "
        "wg * BN / 32);\n", "      PMARK(5)\n")
    put("  if constexpr (C::kSplitDq) {\n    // dQ = the two partials' sum",
        "  _pt = clock64();\n", after=False)
    store = ("  if (wg == 0)\n    store_grad<T, L>(grad, scale, dq, b, Sq, H, "
             "h, q0, DT, warp, lane);\n")
    put(store, "  PMARK(6)\n  PFLUSH(1)\n")
    return src + TAIL


def cuda_ms(fn, reps=5, warmup=1):
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
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layer", choices=sorted(LAYERS), default="gemma2-global")
    shape, opts = LAYERS[ap.parse_args().layer]
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_phases: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(fa.BWD_SOURCE.parent / "sm90.cuh", OUT / "sm90.cuh")
    src = OUT / "flash_attention_bwd_phases.cu"
    src.write_text(instrument(fa.BWD_SOURCE.read_text()))
    lib_path = OUT / "libflash_attention_bwd_phases.so"
    kbuild.build_all([fa.BWD_SOURCE])  # the committed kernel
    subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.flash_attention_bwd
    fn.argtypes = [vp] * 10 + [ci] * 7 + [cf, ci, ci, cf, ci, vp]
    fn.restype = ci
    lib.flash_bwd_phases_read.argtypes = [vp]
    lib.flash_bwd_phases_read.restype = ci
    lib.flash_bwd_phases_zero.restype = ci

    B, H, KV, Sq, Sk, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"card: {card}; shape (B, H, KV, Sq, Sk, D) = {shape}, {opts}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(B, Sk, KV, D, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        dout = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dtype)
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **opts)
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
        delta = torch.empty(B, H, Sq, device="cuda")

        def marked():
            rc = fn(*(t.data_ptr() for t in (q, k, v, out, dout, lse, delta,
                                             *grads)),
                    B, H, KV, Sq, Sk, D, fa.BWD_DTYPE_CODES[dtype],
                    1.0 / math.sqrt(D), int(opts["causal"]), 0,
                    opts.get("softcap", 0.0), 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"flash_bwd_phases: launch failed ({rc})")

        marked()
        torch.cuda.synchronize()
        lib.flash_bwd_phases_zero()
        marked()
        torch.cuda.synchronize()
        cyc = (ctypes.c_ulonglong * 32)()
        lib.flash_bwd_phases_read(ctypes.cast(cyc, vp))
        for kid, kernel in enumerate(KERNELS):
            for wg, role in enumerate(ROLES[kernel]):
                at = (kid * 2 + wg) * 8
                items = cyc[at + 7]
                total = sum(cyc[at + p] for p in range(len(PHASES)))
                print(f"{name} {kernel}, warpgroup {wg} ({role}): cycles an "
                      f"item and consumer warp, mean over {items} "
                      "(items x warps)")
                for p, phase in enumerate(PHASES):
                    print(f"  {phase:34s} {cyc[at + p] / max(items, 1):10.1f}"
                          f"  {cyc[at + p] / max(total, 1):6.1%}")
                print(f"  {'an item':34s} {total / max(items, 1):10.1f}")
        want = ops.flash_attention_bwd(q, k, v, out, lse, dout, force="cuda",
                                       **opts)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads, want))
        ms_marked = cuda_ms(marked)
        ms_plain = cuda_ms(lambda: ops.flash_attention_bwd(
            q, k, v, out, lse, dout, force="cuda", **opts))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                        force="cuda", **opts)
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            for kernel in ("flash_bwd_delta", *KERNELS):
                if kernel in e.key:
                    parts[kernel] = e.self_device_time_total / 3 / 1e3
        print(f"{name}: instrumented {ms_marked:.4f} ms, committed "
              f"{ms_plain:.4f} ms a launch; outputs "
              f"{'bitwise equal' if same else 'DIFFER'}; by kernel (ms, "
              "torch.profiler): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in parts.items()))
        if not same:
            raise SystemExit("flash_bwd_phases: the marks changed the result")
        del q, k, v, dout, out, lse, grads, delta, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
