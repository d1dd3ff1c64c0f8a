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
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ShapeConfig, get_config, reduced_config
from repro_torch.models import Model, input_specs


def make_serve_steps(model: Model, force: str = "auto"):
    """(prefill_step, decode_step) of `model`; `force` goes to the
    layers' kernel wrapper in prefill."""

    def prefill_step(params, batch):
        return model.prefill(params, batch, force=force)

    def decode_step(params, cache, tokens, pos):
        return model.decode(params, cache, tokens, pos)

    return prefill_step, decode_step


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
    the first token). For the SSM and hybrid families the cache is built
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
    prefill_step, decode_step = make_serve_steps(model, force)
    B, P = prompts.shape
    batch = {"tokens": prompts}
    if frontend_embeds is not None:
        if model.cfg.family in ("ssm", "hybrid"):
            raise ValueError(f"{model.cfg.name}: frontend embeddings need a "
                             "prefill cache; this family builds none")
        batch["frontend_embeds"] = frontend_embeds
        P += frontend_embeds.shape[1]  # positions before the first token
    logits, pre = prefill_step(params, batch)
    if pre is not None:
        cache = model.cache_template(B, P + gen_len, dtype=pre["k"].dtype)
        cache["k"][:, :, :P].copy_(pre["k"])
        cache["v"][:, :, :P].copy_(pre["v"])
        del pre
    elif gen_len > 1:
        _, cache = warm_up(model, params, prompts,
                           model.cache_template(B, P + gen_len))
    tok = logits.argmax(dim=-1)
    out = [tok]
    for i in range(gen_len - 1):
        pos = torch.full((B,), P + i, dtype=torch.long, device=prompts.device)
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
