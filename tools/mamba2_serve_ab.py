#!/usr/bin/env python3
"""mamba2-130m's bf16 serving phase of ``chip_smoke.py``, run for two trees.

    python3 tools/mamba2_serve_ab.py --trees BASE NEW   # BASE, NEW, NEW, BASE
    python3 tools/mamba2_serve_ab.py --one TREE         # one tree, one line

Each tree is a checkout of the repo with its own ``chip_smoke.py``.
``--trees`` prints the card's name and power limit, runs ``--one`` in a
fresh process for each tree in the order BASE, NEW, NEW, BASE, so that a
drift of the card or the host over the call falls on both alike, and
prints the four JSON lines and the mean of each metric by tree. ``--one``
imports the tree's ``chip_smoke`` and runs its ``phase_ssm_serve`` as the
script does (full-depth bf16 mamba2-130m from the script's seed, 16 x
2048 prompt tokens, 32 generated, every check of the phase), and reports
the numbers of the phase's log line: the prefill by the host clock around
a synchronise, the decode warm-up over the prompt, the decode ms a token
and the serve call end to end; beside them the bf16 SSD kernel at the
serving layer by CUDA events. Needs a CUDA device and nvcc; imports
nothing of JAX.
"""
import argparse
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

METRICS = ("prefill_ms", "warm_up_ms", "decode_ms_per_token", "serve_ms",
           "ssd_bf16_ms")
LINE = re.compile(r"prefill ([\d.]+) ms .* decode warm-up over the prompt "
                  r"([\d.]+) ms .* decode ([\d.]+) ms/token .* serve end to "
                  r"end ([\d.]+) ms")


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    smoke = importlib.import_module("chip_smoke")
    torch = smoke.torch
    if not torch.cuda.is_available():
        raise SystemExit("mamba2_serve_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lines = []
    smoke.log = lines.append
    smoke.phase_ssm_serve()
    found = [m for m in map(LINE.search, lines) if m]
    if len(found) != 1:
        raise SystemExit(f"mamba2_serve_ab: no single timing line in {lines}")
    out = {"tree": str(tree)}
    out.update(zip(METRICS, map(float, found[0].groups())))
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    x, dt, A, Bm, Cm, D = smoke.ssd_inputs(*smoke.SSD_SHAPE, "mamba2", gen)
    args = [t.to(torch.bfloat16) for t in (x, dt)] + [A] \
        + [t.to(torch.bfloat16) for t in (Bm, Cm)] + [D]
    out["ssd_bf16_ms"] = smoke.cuda_ms(
        lambda: smoke.ops.ssd_scan(*args, force="cuda"), reps=10, warmup=2)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--one", type=Path)
    group.add_argument("--trees", type=Path, nargs=2)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one.resolve())), flush=True)
        return
    base, new = (t.resolve() for t in args.trees)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    for tree in (base, new, new, base):
        res = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"mamba2_serve_ab: {tree} exited "
                             f"{res.returncode}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for label, tree in (("base", base), ("new", new)):
        mine = [r for r in runs if r["tree"] == str(tree)]
        print(json.dumps({"mean": label, **{
            key: sum(r[key] for r in mine) / len(mine) for key in METRICS}}),
            flush=True)


if __name__ == "__main__":
    main()
