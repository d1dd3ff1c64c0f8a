"""gemma2-9b: dense decoder with alternating local/global attention + softcaps.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
head_dim=256 (explicit, d_model/num_heads=224 is NOT used by gemma2).
Local layers use a 4096-token sliding window; attn logits capped at 50,
final logits at 30. Embeddings tied (gemma family). The port's copy of the
reference's ``configs/gemma2_9b.py``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118; hf",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=10000.0,
    sliding_window=4096,
    local_global=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    tie_embeddings=True,
)
