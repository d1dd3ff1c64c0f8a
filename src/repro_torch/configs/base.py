"""Architecture and input-shape configuration system.

The port's own copy of the reference's ``configs/base.py``: every
architecture is a frozen ``ArchConfig``, the four input shapes are
``ShapeConfig``s, and ``ArchConfig.param_count`` gives the analytic
parameter count. ``tests/test_torch_isolation.py`` holds the copy equal to
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape (seq_len x global_batch)."""

    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One assigned architecture (exact public config; see per-arch file)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # arctic: dense MLP in parallel with MoE

    # --- attention flavour ---
    rope_theta: float = 10000.0
    sliding_window: int = 0  # >0: window size used by 'local' layers
    local_global: bool = False  # gemma2: alternate local/global layers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: shared attn block after every k ssm blocks
    shared_attention: bool = False  # zamba2: the attn block weights are shared

    # --- modality frontend (STUB: input_specs() provides embeddings) ---
    frontend: str = "none"  # 'none' | 'vision' | 'audio'
    frontend_tokens: int = 0

    # --- numerics / training ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        # multiple of 128 keeps the vocab dim MXU-aligned and 16-way shardable
        return round_up(self.vocab_size, 128)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def supports_shape(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """long_500k requires sub-quadratic attention (SSM / hybrid)."""
        if shape.name == "long_500k" and not self.has_ssm:
            return False, (
                "long_500k skipped: full-attention KV cache at 524288 ctx is "
                "quadratic-prefill and exceeds serving HBM; run only for "
                "ssm/hybrid archs (see DESIGN.md §Arch-applicability)"
            )
        return True, ""

    # ------------------------------------------------------------------
    # Analytic parameter counts (cross-checked against eval_shape in tests).
    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        return self.d_model * self.num_heads * hd + 2 * self.d_model * self.num_kv_heads * hd + self.num_heads * hd * self.d_model

    def _dense_mlp_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def _ssm_params(self) -> int:
        di, st, nh = self.ssm_inner, self.ssm_state, self.ssm_heads
        in_proj = self.d_model * (2 * di + 2 * st + nh)
        conv = self.ssm_conv * (di + 2 * st)
        out = di * self.d_model
        extras = 2 * nh + nh  # A_log, D, dt_bias
        return in_proj + conv + out + extras

    def param_count(self, active_only: bool = False) -> int:
        """Total (or routing-active) parameter count, embeddings included."""
        emb = self.padded_vocab * self.d_model
        total = emb if self.tie_embeddings else 2 * emb
        per_layer = 2 * self.d_model  # norms
        if self.family == "ssm":
            per_layer += self._ssm_params()
            total += self.num_layers * per_layer
            return total
        if self.family == "hybrid":
            ssm_layer = per_layer + self._ssm_params()
            total += self.num_layers * ssm_layer
            n_sites = self.num_layers // max(self.attn_every, 1)
            attn_block = self._attn_params() + self._dense_mlp_params(self.d_ff) + 2 * self.d_model
            total += attn_block if self.shared_attention else n_sites * attn_block
            return total
        # dense / moe / vlm / audio transformer
        per_layer += self._attn_params()
        if self.num_experts:
            n_e = self.experts_per_token if active_only else self.num_experts
            per_layer += n_e * self._dense_mlp_params(self.d_ff)
            per_layer += self.d_model * self.num_experts  # router (always dense)
            if self.moe_dense_residual:
                per_layer += self._dense_mlp_params(self.d_ff)
        else:
            per_layer += self._dense_mlp_params(self.d_ff)
        total += self.num_layers * per_layer
        return total

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

    def model_flops(self, shape: ShapeConfig) -> float:
        """MODEL_FLOPS = 6 * N_active * D (training) or 2 * N_active * D (fwd)."""
        mult = 6.0 if shape.kind == "train" else 2.0
        return mult * self.active_param_count() * shape.tokens
