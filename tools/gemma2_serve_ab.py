#!/usr/bin/env python3
"""gemma2-9b's flash layers and serving, timed on the card for two trees.

    python3 tools/gemma2_serve_ab.py --trees BASE NEW   # BASE, NEW, NEW, BASE
    python3 tools/gemma2_serve_ab.py --one TREE         # one tree, one line

Each tree is a checkout of the repo (its ``src/`` holds ``repro_torch``).
``--trees`` prints the card's name and power limit, runs ``--one`` in a
fresh process for each tree in the order BASE, NEW, NEW, BASE, so that a
drift of the card over the call falls on both alike, and prints the four
JSON lines and the mean of each metric by tree. ``--one`` builds the
tree's kernels, then times by CUDA events the bf16 wgmma flash kernel at
gemma2-9b's local and global prefill layers (B 4, H 16, KV 8, S 4608, D
256, softcap 50; the local layer's window 4096), and draws full-size bf16
gemma2-9b from seed 0 on the card and serves 4 x 4608 random prompt
tokens as ``chip_smoke.py`` does: the prefill alone (one token) by the
host clock around a synchronise, then a call that generates 32, whose
time beyond the prefill's is 31 decode steps. Needs a CUDA device and
nvcc; imports nothing of JAX.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

B, H, KV, S, D = 4, 16, 8, 4608, 256
GEN, SEED, REPS = 32, 0, 20


def cuda_ms(torch, fn, reps=REPS, warmup=3):
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


def one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as flash_build
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    if not torch.cuda.is_available():
        raise SystemExit("gemma2_serve_ab: no CUDA device")
    kbuild.build_all(flash_build.SOURCES)
    out = {"tree": str(tree)}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(B, S, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    for name, opts in (("flash_local_ms", dict(window=4096, softcap=50.0)),
                       ("flash_global_ms", dict(softcap=50.0))):
        out[name] = cuda_ms(torch, lambda: ops.flash_attention(
            q, k, v, force="cuda", **opts))
    del q, k, v

    cfg = get_config("gemma2-9b")
    model = Model(cfg)
    params = model.init(SEED)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device="cuda")
    serve(model, params, prompts[:, :256], 2)  # handles, library, caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(model, params, prompts, 1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tokens, _ = serve(model, params, prompts, GEN)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    out["prefill_ms"] = 1e3 * prefill_s
    out["decode_ms_per_token"] = 1e3 * (total_s - prefill_s) / (GEN - 1)
    out["tokens_head"] = tokens[0, :8].tolist()
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
            raise SystemExit(f"gemma2_serve_ab: {tree} exited "
                             f"{res.returncode}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    for label, tree in (("base", base), ("new", new)):
        mine = [r for r in runs if r["tree"] == str(tree)]
        mean = {key: sum(r[key] for r in mine) / len(mine)
                for key in ("flash_local_ms", "flash_global_ms",
                            "prefill_ms", "decode_ms_per_token")}
        print(json.dumps({"mean": label, **mean}), flush=True)


if __name__ == "__main__":
    main()
