"""zamba2-7b: hybrid — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; unverified] 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64. One SHARED attention+MLP block is applied after
every 6 Mamba2 blocks (weights shared across all application sites, as in
Zamba's shared-block design). ssm head_dim=64 -> d_inner=7168, 112 ssm heads.

Long-context note (DESIGN.md §Arch-applicability): at long_500k serving the
shared attention runs with a 4096 sliding window (SSM carries global state),
keeping the KV cache bounded. The port's copy of the reference's
``configs/zamba2_7b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242; unverified",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    attn_every=6,
    shared_attention=True,
    sliding_window=4096,  # engaged only for long-context serving
    rope_theta=10000.0,
)
