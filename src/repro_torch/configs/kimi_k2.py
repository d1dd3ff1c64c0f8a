"""kimi-k2-1t-a32b: trillion-parameter MoE, 384 experts top-8.

[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(per-expert) vocab=163840, MoE 384e top-8. head_dim=128 explicit
(d_attn = 64*128 = 8192 != d_model, as in the DeepSeek-V3 lineage). The
port's copy of the reference's ``configs/kimi_k2.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2; unverified",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    rope_theta=50000.0,
)
