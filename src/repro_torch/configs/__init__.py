"""Configurations of the port (its own copies of the reference's).

``sodda_svm`` holds the SODDA instances. The architecture registry
(``get_config`` / ``list_archs`` / ``reduced_config``) holds the
reference's ten architectures, the MoE family's arctic-480b and kimi-k2
among them; any other name raises ``KeyError`` with the list of known
ones, as the reference's registry does.
"""
import dataclasses

from repro_torch.configs import (arctic_480b, chatglm3_6b, gemma2_9b,
                                 internvl2_26b, kimi_k2, mamba2_130m,
                                 minitron_8b, musicgen_large, phi3_mini,
                                 zamba2_7b)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_REGISTRY = {m.CONFIG.name: m.CONFIG
             for m in (musicgen_large, phi3_mini, chatglm3_6b, minitron_8b,
                       gemma2_9b, internvl2_26b, arctic_480b, kimi_k2,
                       mamba2_130m, zamba2_7b)}

# short aliases: --arch phi3_mini as well as --arch phi3-mini-3.8b
_ALIASES = {"musicgen_large": "musicgen-large",
            "phi3_mini": "phi3-mini-3.8b", "chatglm3_6b": "chatglm3-6b",
            "minitron_8b": "minitron-8b", "gemma2_9b": "gemma2-9b",
            "internvl2_26b": "internvl2-26b", "mamba2_130m": "mamba2-130m",
            "zamba2_7b": "zamba2-7b", "arctic_480b": "arctic-480b",
            "kimi_k2": "kimi-k2-1t-a32b"}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[key]


def reduced_config(cfg: ArchConfig, seq_chunk: int = 16) -> ArchConfig:
    """Small same-family config for CPU smoke tests (few layers, small
    width, few experts, tiny vocab); the reference's rule, copied."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=4 if cfg.family == "hybrid" else 2,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        num_experts=8 if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        frontend_tokens=8 if cfg.frontend_tokens else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=seq_chunk,
        attn_every=2 if cfg.attn_every else 0,
        sliding_window=8 if cfg.sliding_window else 0,
    )


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_config", "list_archs",
           "reduced_config"]
