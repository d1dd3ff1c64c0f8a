"""Serving: prefill/decode steps and a batched-request driver.

Counterpart of ``repro.launch.serve``. ``serve`` answers a batch of
requests: it prefills the prompts (one kernel launch per layer: flash
attention for the dense and MoE families, the SSD scan for the SSM
family; the hybrid family launches the SSD scan in every layer and flash
attention at every site of its shared block), builds the decode cache,
and decodes greedily one token at a time. The dense and MoE families copy
the prefill keys and values into a cache sized for the whole generation.
The SSM and hybrid families' prefill builds no decode state, as in the
reference, whose serving CLI feeds the prompt token by token through
decode: ``warm_up`` does the same. The CLI serves a batch of random
prompts through it:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic_480b

(on the CUDA device; ``--device cpu`` runs it on the CPU). ``--no-reduced``
serves the full-size configuration. Every arch of the registry serves:
phi3-mini-3.8b, minitron-8b, chatglm3-6b, musicgen-large and internvl2-26b
run the dense stack as gemma2-9b does, and arctic-480b and kimi-k2 run it
with an MoE block in each layer (its prefill launches flash attention
once a layer too; the MoE family needs no branch here). A config with a frontend
(internvl2-26b's vision stub) is served with stand-in embeddings of
``input_specs``' shape drawn from the CLI's seeded generator, put ahead of
each prompt.

Over a mesh of ranks (a ``Model`` on a ``core.distributed.Mesh``)
``serve`` runs on each rank with its shards of the parameters: the rank
takes its rows of the prompts (``serve_row_axes``), its prefill and
decode run tensor-parallel over 'model', and its cache is its shard
(``Model.cache_template``): its kv heads in 'heads' decode, its chunk of
the sequence in 'seq' decode (``sharding_rules.decode_mode``), for the
SSM and hybrid families the state's heads as the rules split them. An MoE
layer routes the global batch's tokens: the prefill's B x P, each decode
step's B over every expert's capacity buffer, as on one device.
``serve_shardings`` gives the reference's layouts as specs. Its token
spec may lay the SSM family's rows over 'model' too (``batch_axes``),
while its cache spec lays the state's rows over the data axes alone
('data', or ('pod', 'data') on a mesh with a 'pod' axis); the prompt of
the SSM and hybrid families goes through decode (``warm_up``), so a rank
here serves the cache's rows, prefill included, and decode follows the
cache's layout. A hybrid on a grid whose model axis does not divide its
kv heads does not serve (``transformer._serving_on_mesh``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.distributed.sharding_rules import (PartitionSpec as P,
                                                    activation_pspec_fn,
                                                    axis_names, batch_axes,
                                                    decode_mode)
from repro_torch.launch.train import rank_rows
from repro_torch.models import Model, input_specs

LONG_CONTEXT = 100_000  # positions past which decode is long-context


def make_serve_steps(model: Model, shape: Optional[ShapeConfig] = None,
                     force: str = "auto"):
    """(prefill_step, decode_step) of `model` for the cell `shape`, as the
    reference's: decode is long-context past ``LONG_CONTEXT`` positions
    (``shape.seq_len``), and over a mesh both steps take the reference's
    activation spec function, with the model's `rules_overrides` (the
    reference's takes none, so its MoE activations ask for the 'gather'
    layout whatever the weights'; GSPMD reshards them, while a rank here
    runs its experts where its shards lie). `force` goes to the layers'
    kernel wrapper in prefill."""
    long_ctx = shape is not None and shape.seq_len > LONG_CONTEXT
    pspec_fn = (activation_pspec_fn(model.cfg, shape, model.mesh,
                                    model.rules_overrides,
                                    serve_row_axes(model, shape))
                if model.mesh is not None and shape is not None else None)

    def prefill_step(params, batch):
        return model.prefill(params, batch, force=force, pspec_fn=pspec_fn)

    def decode_step(params, cache, tokens, pos):
        return model.decode(params, cache, tokens, pos,
                            long_context=long_ctx, pspec_fn=pspec_fn)

    return prefill_step, decode_step


def serve_row_axes(model: Model, shape: ShapeConfig):
    """The mesh axes a serving rank's rows lie over: the cache's
    (``Model.cache_pspecs``: the data axes, 'pod' and 'data' on a mesh
    with a 'pod' axis, when the batch divides them, else none). It is the
    token spec's (``batch_axes``) for a family whose prefill builds the
    decode cache, except where ``batch_axes`` falls back to a prefix of
    the data axes, ('pod',), and the cache's rows stay whole: a rank then
    serves every row, as its cache holds them. The SSM and hybrid
    families' decode state is built by ``warm_up``, through decode, whose
    rows are the cache's; their token spec may lay the rows over 'model'
    too."""
    specs = model.cache_pspecs(shape)
    return axis_names(specs["state" if "state" in specs else "k"][1])


def serve_shardings(model: Model, shape: ShapeConfig):
    """The reference's ``serve_shardings`` as specs: (param specs, cache
    specs, token spec, position spec)."""
    axes = batch_axes(model.cfg, shape, model.mesh)
    b = axes if len(axes) > 1 else (axes[0] if axes else None)
    return model.pspecs(), model.cache_pspecs(shape), P(b, None), P(b)


def fill_cache(model: Model, cache, pre, P_: int):
    """The prefill's keys and values (P_ positions) copied into the
    decode cache: a rank in 'seq' decode keeps the positions its chunk
    holds."""
    if model.tp is not None and decode_mode(model.cfg, model.mesh) == "seq":
        S_loc = cache["k"].shape[2]
        lo = model.tp.rank * S_loc
        n = max(0, min(P_ - lo, S_loc))
        for k in ("k", "v"):
            cache[k][:, :, :n].copy_(pre[k][:, :, lo:lo + n])
        return cache
    cache["k"][:, :, :P_].copy_(pre["k"])
    cache["v"][:, :, :P_].copy_(pre["v"])
    return cache


def warm_up(model: Model, params, prompts, cache):
    """Feed prompts (B, P) through decode, positions 0 ... P-1, into
    `cache` (updated in place): the SSM and hybrid families' decode state
    after the prompt. Returns (logits (B, Vp) f32 of the last position,
    cache)."""
    B, P = prompts.shape
    for i in range(P):
        pos = torch.full((B,), i, dtype=torch.long, device=prompts.device)
        logits, cache = model.decode(params, cache, prompts[:, i:i + 1], pos)
    return logits, cache


def serve(model: Model, params, prompts, gen_len: int, force: str = "auto",
          frontend_embeds=None):
    """Greedy generation for a batch of requests.

    prompts (B, P) integer tensor on the model's device -> (tokens (B,
    gen_len), prefill logits (B, Vp) f32 of the last prompt position).
    The first token comes from the prefill logits, each further one from a
    decode step, so there are gen_len - 1 decode steps over a cache of
    P + gen_len positions; gen_len = 1 is the prefill alone (the time to
    the first token). Over a mesh of ranks `prompts` (and
    `frontend_embeds`) are the whole batch: the rank serves its rows of
    it, and the tokens and logits returned are those rows'. For the SSM
    and hybrid families the cache is built
    by ``warm_up`` (P decode steps) when gen_len > 1; past 2 x the
    hybrid family's window (P + gen_len positions) its attention cache is a
    ring of the window's slots, and decode sees the last `window` positions
    only, while the prefill that gives the first token attends to all of
    them, as the reference's serving steps do. `frontend_embeds` (B, F, d)
    (the vlm family's stand-in patch embeddings) go ahead of each prompt:
    the cache then holds F + P + gen_len positions and decode starts at
    position F + P. Greedy argmax runs over the padded vocabulary, as the
    reference's does. `force` goes to the layers' kernel wrapper in
    prefill. Nothing here synchronises with the host.
    """
    if gen_len < 1:
        raise ValueError(f"gen_len must be >= 1, got {gen_len}")
    B, P = prompts.shape
    shape = ShapeConfig("serve", "decode", P + gen_len, B)
    prefill_step, decode_step = make_serve_steps(model, shape, force)
    batch = {"tokens": prompts}
    if frontend_embeds is not None:
        if model.cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"{model.cfg.name}: frontend embeddings need a "
                             "prefill cache; this family builds none")
        batch["frontend_embeds"] = frontend_embeds
        P += frontend_embeds.shape[1]  # positions before the first token
    if model.tp is not None:
        batch = rank_rows(model, shape, batch, serve_row_axes(model, shape))
        prompts = batch["tokens"]
    logits, pre = prefill_step(params, batch)
    if pre is not None:
        cache = model.cache_template(B, P + gen_len, dtype=pre["k"].dtype)
        cache = fill_cache(model, cache, pre, P)
        del pre
    elif gen_len > 1:
        _, cache = warm_up(model, params, prompts,
                           model.cache_template(B, P + gen_len))
    tok = logits.argmax(dim=-1)
    out = [tok]
    for i in range(gen_len - 1):
        pos = torch.full((tok.shape[0],), P + i, dtype=torch.long,
                         device=prompts.device)
        step_logits, cache = decode_step(params, cache, tok[:, None], pos)
        tok = step_logits.argmax(dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1), logits


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen_len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = Model(cfg, device=args.device, param_dtype=torch.float32)
    params = model.init(0)
    gen = torch.Generator(device=model.device).manual_seed(7)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=model.device)
    embeds = None
    spec = input_specs(cfg, ShapeConfig("cli", "prefill", args.prompt_len,
                                        args.batch)).get("frontend_embeds")
    if spec is not None:  # the frontend's stand-in: unit-variance patches
        embeds = torch.randn(spec.shape, generator=gen, device=model.device
                             ).to(spec.dtype)

    t0 = time.perf_counter()
    tokens, _ = serve(model, params, prompts, args.gen_len,
                      frontend_embeds=embeds)
    tokens = tokens.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    n = args.batch * args.gen_len
    front = "" if embeds is None else f"frontend={embeds.shape[1]} "
    print(f"served batch={args.batch} {front}prompt={args.prompt_len} "
          f"gen={args.gen_len} of {cfg.name} on {model.device} in {dt:.2f}s "
          f"({n / dt:.1f} generated tok/s)")
    print("sample:", tokens[0, :24].tolist())
    return tokens


if __name__ == "__main__":
    main()
