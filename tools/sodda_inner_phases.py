#!/usr/bin/env python3
"""Where a chain's time goes inside the ``sodda_inner`` kernel, on the card.

    python3 tools/sodda_inner_phases.py [--source PATH ...]

For each source (default: ``src/repro_torch/kernels/csrc/sodda_inner.cu``;
an older copy of that file, such as the one-block-per-chain kernel of the
port's first slice, may be given beside it) this copies the source into
``build/sodda_phases/`` twice: as it is, and with ``clock64()`` marks added
between the phases of a chain. It builds both with the port's nvcc flags,
runs the marked one once at the Table-1 shape (15, 64, 1200) with the hinge
loss, checks that both give the same bits, and prints the mean cycles of
each phase:

* one block per chain, 256 threads (the first slice's layout), thread 0's
  view: block start and the loads of w0/mu, the d0 pass, and per step the
  loads and dot, the reduction (shuffle, block barrier, sum of the warps'
  partials), the loss and the axpy, then the write-out;
* one warp per chain (the current layout), the chain warp's view: the
  issue of its loads of w0/mu, the block's one barrier, the wait for the
  first row, and per step the dot (it waits for the row's loads), the
  butterfly, the release of the slot, the wait for the next row's `ready`
  (its row and d0) and the issue of its loads, the loss and the axpy, then
  the write-out; per row, the d0 helpers' wait and work and the producer's
  wait for a free slot and its issue.

A mark reads the clock when the instructions before it have issued, so a
load's latency shows in the phase that first uses it. The phases sum to
the chain's time. It then times the unmarked kernel of each source the
same way as ``chip_smoke.py`` (whose timing and inputs it uses): launches
captured in a CUDA graph after warm-up, and the C entry point called in a
loop with resolved pointers between CUDA events. Fails if a source no
longer has the lines it marks. Needs a CUDA device and nvcc; imports
nothing of JAX.
"""
import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its timing, inputs and card line)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import sodda_inner as kernel_build  # noqa: E402

SHAPE = (15, 64, 1200)  # (B, L, mt): Table-1, P * Q chains of L rows
GAMMA = chip_smoke.KERNEL_GAMMA["hinge"]
OUT = ROOT / "build" / "sodda_phases"

HEAD = """
__device__ unsigned long long g_phase[16];
#define PSTART unsigned long long _pt = clock64();
#define PMARK(k) { unsigned long long _n = clock64(); _acc[k] += _n - _pt; _pt = _n; }
#define PFLUSH(lo, hi) { if ((threadIdx.x & 31) == 0) for (int _k = lo; _k < hi; ++_k) atomicAdd(&g_phase[_k], _acc[_k]); }
"""
TAIL = """
extern "C" int sodda_phases_read(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
"""
ZERO = "unsigned long long _acc[16] = {0};\n"

# (phase index, name, divisor): "block" per chain, "step" per step of a
# chain, "row" per row of a chain.
BLOCK_PHASES = [
    (0, "block start + w0/mu loads (to the first barrier)", "block"),
    (1, "d0 pass (to the second barrier)", "block"),
    (2, "step: loads + dot", "step"),
    (3, "step: reduction (shuffle, barrier, 8 partials)", "step"),
    (4, "step: loss", "step"),
    (5, "step: axpy", "step"),
    (6, "write-out", "block"),
]
CHAIN_PHASES = [
    (0, "chain: w0/mu loads issued", "block"),
    (1, "chain: the block barrier (the barriers' set-up)", "block"),
    (2, "chain: wait for the first row, its loads", "block"),
    (3, "step: dot (waits for the row's loads)", "step"),
    (4, "step: butterfly", "step"),
    (5, "step: d0/y read, release", "step"),
    (6, "step: wait for the next row's ready", "later step"),
    (7, "step: issue of the next row's loads", "later step"),
    (8, "step: loss", "step"),
    (9, "step: axpy", "step"),
    (10, "write-out", "block"),
]
HELPER_PHASES = [(11, "d0 helper: wait for full", "row"),
                 (12, "d0 helper: dot, butterfly, loss, release", "row")]
PRODUCER_PHASES = [(13, "producer: wait for a free slot", "row"),
                   (14, "producer: copy issue and y_i", "row")]


class Source:
    """A source text with anchored insertions; fails on a missing anchor."""

    def __init__(self, text):
        self.text = text

    def put(self, anchor, insert, after=True):
        if self.text.count(anchor) != 1:
            raise SystemExit(f"sodda_inner_phases: the source no longer has "
                             f"exactly one {anchor.strip()!r}")
        self.text = self.text.replace(
            anchor, anchor + insert if after else insert + anchor)

    def sub(self, anchor, text):
        """Replace the one `anchor` by `text`."""
        self.put(anchor, "")
        self.text = self.text.replace(anchor, text)


def instrument_block(src: Source):
    """The first slice's layout: thread 0 marks every phase."""
    src.put("namespace {\n", HEAD, after=False)
    src.put("  const size_t b = blockIdx.x;\n", "  " + ZERO + "  PSTART\n")
    src.put("    s_mu[j] = mu[b * mt + j];\n  }\n  __syncthreads();\n",
            "  PMARK(0)\n")
    src.put("    if (lane == 0) s_d0[i] = loss_deriv<LOSS>(s, yb[i]);\n"
            "  }\n  __syncthreads();\n", "  PMARK(1)\n")
    src.put("    for (int j = tid; j < mt; j += kThreads) part += x[j] * "
            "s_wbar[j];\n", "    PMARK(2)\n")
    src.put("    for (int w = 0; w < kWarps; ++w) z1 += red[w];\n",
            "    PMARK(3)\n")
    src.put("    const float c = loss_deriv<LOSS>(z1, yb[i]) - s_d0[i];\n",
            "    PMARK(4)\n")
    src.put("      s_wbar[j] -= gamma * (c * x[j] + s_mu[j]);\n    }\n",
            "    PMARK(5)\n")
    src.put("  for (int j = tid; j < mt; j += kThreads) out[b * mt + j] = "
            "s_wbar[j];\n", "  PMARK(6)\n  if (tid == 0) PFLUSH(0, 7)\n")


def instrument_chain(src: Source):
    """The one-warp chain: marks in the chain (register path), the d0
    helpers and the producer."""
    src.put("namespace {\n", HEAD, after=False)
    # the chain
    src.put("  float4 w[G], m[kMuRegs ? G : 1], xa[G], xb[G];\n",
            "  " + ZERO + "  PSTART\n")
    src.sub("  }\n  block_barrier();\n\n  int slot = 0;\n  uint32_t phase = 0;\n"
            "  if (L > 0) {\n    mbar_wait(s.ready, 0);\n"
            "    load_row<G>(row4(s, 0, pitch), nq, lane, xa);\n  }\n",
            "  }\n  PMARK(0)\n  block_barrier();\n  PMARK(1)\n\n  int slot = 0;\n"
            "  uint32_t phase = 0;\n  if (L > 0) {\n    mbar_wait(s.ready, 0);\n"
            "    load_row<G>(row4(s, 0, pitch), nq, lane, xa);\n  }\n"
            "  PMARK(2)\n")
    src.sub("    const float4 acc = dot4<G>(x, w);\n"
            "    const float z1 = warp_sum(sum4(acc));\n",
            "    const float4 acc = dot4<G>(x, w);\n    PMARK(3)\n"
            "    const float z1 = warp_sum(sum4(acc));\n    PMARK(4)\n")
    src.sub("    advance(slot, phase, 1, slots);\n    if (i + 1 < L) {\n"
            "      mbar_wait(s.ready + 8 * slot, phase);  // row i + 1 and its "
            "d0\n      load_row<G>(row4(s, slot, pitch), nq, lane, xn);\n    }\n",
            "    advance(slot, phase, 1, slots);\n    PMARK(5)\n"
            "    if (i + 1 < L) {\n      mbar_wait(s.ready + 8 * slot, phase);\n"
            "      PMARK(6)\n"
            "      load_row<G>(row4(s, slot, pitch), nq, lane, xn);\n"
            "      PMARK(7)\n    }\n")
    src.sub("    const float c = loss_deriv<LOSS>(z1, dy.y) - dy.x;\n"
            "#pragma unroll\n",
            "    const float c = loss_deriv<LOSS>(z1, dy.y) - dy.x;\n"
            "    PMARK(8)\n#pragma unroll\n")
    src.put("      axpy4(w[g], x[g], mg, c, gamma);\n    }\n", "    PMARK(9)\n")
    src.put("  for (int g = 0; g < G; ++g) store4(outb, lane + 32 * g, mt, "
            "w[g]);\n", "  PMARK(10)\n  PFLUSH(0, 11)\n")
    # the d0 helpers
    src.put("  block_barrier();\n  if (h >= helpers) return;\n",
            "  " + ZERO + "  PSTART\n")
    src.put("    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n"
            "    if constexpr (G > 0) {\n      load_row<G>(x4, nq, lane, x);\n",
            "    PMARK(11)\n", after=False)
    src.put("    advance(slot, phase, helpers, slots);\n", "    PMARK(12)\n")
    src.put("    PMARK(12)\n  }\n", "  PFLUSH(11, 13)\n")
    # the producer
    src.put("  float ynext = 32 + lane < L ? yb[32 + lane] : 0.0f;\n"
            "  block_barrier();\n", "  " + ZERO + "  PSTART\n")
    src.put("    mbar_wait(s.empty + 8 * slot, phase ^ 1u);  // the first use "
            "passes\n", "    PMARK(13)\n")
    src.put("      mbar_arrive(full);  // releases the y_i store\n    }\n"
            "    advance(slot, phase, 1, slots);\n", "    PMARK(14)\n")
    src.put("    PMARK(14)\n  }\n", "  PFLUSH(13, 15)\n")


def build(text: str, tag: str) -> ctypes.CDLL:
    """Build `text` into a library under OUT (cached by content)."""
    OUT.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    src = OUT / f"{tag}_{digest}.cu"
    lib = OUT / f"lib{tag}_{digest}.so"
    if not lib.exists():
        src.write_text(text)
        done = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o",
                               str(lib), str(src)], capture_output=True,
                              text=True)
        if done.returncode != 0:
            raise SystemExit(f"sodda_inner_phases: nvcc failed on {src}:\n"
                             f"{done.stdout}{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    dll.sodda_inner_f32.argtypes = [vp, vp, vp, vp, ctypes.c_float, vp,
                                    ci, ci, ci, ci, vp]
    dll.sodda_inner_f32.restype = ci
    return dll


def caller(dll, args, out):
    """A zero-argument call of the C entry point with resolved pointers."""
    w0, Xl, yl, mu = args
    B, L, mt = Xl.shape
    ptrs = [t.data_ptr() for t in (w0, Xl, yl, mu)]
    fn = dll.sodda_inner_f32
    out_ptr = out.data_ptr()
    code = kernel_build.LOSS_CODES["hinge"]

    def call():
        rc = fn(*ptrs, GAMMA, out_ptr, B, L, mt, code,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sodda_inner_phases: launch failed ({rc})")
    return call


def profile(path: Path, args):
    text = path.read_text()
    layout = "block" if "constexpr int kThreads = 256;" in text else "chain"
    marked = Source(text)
    (instrument_block if layout == "block" else instrument_chain)(marked)
    tag = path.stem.replace(".", "_")
    plain_lib = build(text, tag)
    marked_lib = build(marked.text + TAIL, tag + "_marked")
    marked_lib.sodda_phases_read.argtypes = [ctypes.c_void_p]
    marked_lib.sodda_phases_read.restype = ctypes.c_int

    B, L, mt = SHAPE
    want = torch.empty_like(args[0])
    got = torch.empty_like(args[0])
    caller(plain_lib, args, want)()
    caller(marked_lib, args, got)()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise SystemExit(f"sodda_inner_phases: the marked {path.name} gives "
                         "other bits than the unmarked one")
    sums = (ctypes.c_ulonglong * 16)()
    if marked_lib.sodda_phases_read(sums) != 0:
        raise SystemExit("sodda_inner_phases: reading the marks failed")

    print(f"{path.relative_to(ROOT) if path.is_relative_to(ROOT) else path}"
          f" ({layout} layout) at {SHAPE} hinge, mean cycles:")
    count = {"block": B, "step": B * L, "later step": B * max(L - 1, 1),
             "row": B * L}
    phases = BLOCK_PHASES if layout == "block" else CHAIN_PHASES
    chain_total = 0.0
    for k, name, per in phases:
        c = sums[k] / count[per]
        chain_total += c * {"step": L, "later step": L - 1}.get(per, 1)
        print(f"  {name:52s} {c:10.1f} per {per}")
    step = sum(sums[k] / count[per] for k, _, per in phases
               if per in ("step", "later step"))
    print(f"  {'a step, all its phases':52s} {step:10.1f}")
    print(f"  {'a chain, all its phases':52s} {chain_total:10.1f}")
    if layout == "chain":
        for k, name, per in HELPER_PHASES + PRODUCER_PHASES:
            print(f"  {name:52s} {sums[k] / count[per]:10.1f} per {per}")

    call = caller(plain_lib, args, torch.empty_like(args[0]))
    try:
        kernel_ms = chip_smoke.graph_ms(call)
        how = f"CUDA graph of {chip_smoke.GRAPH_LAUNCHES} launches"
    except RuntimeError as err:  # a launch the graph cannot capture
        kernel_ms, how = None, f"no graph ({err})"
    c_loop_ms = chip_smoke.cuda_ms(call, reps=200)
    shown = "not measured" if kernel_ms is None else f"{kernel_ms:.5f} ms"
    print(f"  kernel {shown} ({how}); C entry point in a loop "
          f"{c_loop_ms:.5f} ms; marked chain {chain_total:.0f} cycles")
    return kernel_ms, c_loop_ms


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", type=Path, action="append",
                        help="a sodda_inner.cu to profile (repeatable; "
                             "default: the port's)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sodda_inner_phases: needs a CUDA device")
    print(f"card: {chip_smoke.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = chip_smoke.kernel_inputs(*SHAPE, gen)
    for path in opts.source or [kernel_build.SOURCE]:
        profile(path.resolve(), args)


if __name__ == "__main__":
    main()
