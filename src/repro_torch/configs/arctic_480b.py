"""arctic-480b: dense-MoE hybrid — 128-expert top-2 MoE + dense residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2, with a dense residual MLP in parallel
with the MoE branch (Arctic's dense+MoE architecture). The 56 q heads are
padded to 64 (``models.attention.padded_heads``). The port's copy of the
reference's ``configs/arctic_480b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base; hf",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    rope_theta=10000.0,
)
