"""Architecture configuration (port of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# Assigned input-shape set (LM transformer shapes)
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 0
    qk_norm: bool = False
    swa_window: int | None = None
    rope: bool = True
    rope_theta: float = 1e4
    causal: bool = True
    # --- MoE ---
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    # --- modality frontend stub ---
    frontend: str | None = None  # "vision" | "audio"
    frontend_dim: int = 0
    frontend_tokens: int = 0     # vision prefix length (vlm)
    # --- numerics ---
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "dots"   # "full" (save nothing) | "dots"
    attn_q_chunk: int = 1024
    ssd_chunk: int = 128
    note: str = ""

    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # ---------------- derived properties -----------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (padded logits are
        masked)."""
        return -(-self.vocab // 128) * 128 if self.vocab else 0

    @property
    def has_attention(self) -> bool:
        return self.family in ("dense", "moe", "encoder", "vlm", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k decode with bounded state?"""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    def runnable_shapes(self) -> list[str]:
        out = ["train_4k", "prefill_32k"]
        if self.has_decode:
            out.append("decode_32k")
            if self.subquadratic:
                out.append("long_500k")
        return out

    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def act_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    def params_count(self) -> int:
        """Approximate parameter count."""
        d, n_l = self.d_model, self.n_layers
        n = self.vocab * d  # embed
        if self.vocab:
            n += self.vocab * d  # untied lm head
        per_layer = 0
        if self.has_attention:
            hdh = self.n_heads * self.d_head
            kvdh = self.n_kv_heads * self.d_head
            per_layer += d * hdh + 2 * d * kvdh + hdh * d
        if self.family in ("dense", "encoder", "vlm", "hybrid") and self.d_ff:
            per_layer += 3 * d * self.d_ff
        if self.family == "moe":
            per_layer += self.moe_experts * 3 * d * self.moe_dff + \
                d * self.moe_experts
        if self.has_ssm:
            d_inner = self.ssm_heads * self.ssm_head_dim
            conv = d_inner + 2 * self.ssm_state
            per_layer += d * (d_inner + conv + self.ssm_heads) + d_inner * d
        return n + n_l * per_layer

    def active_params_count(self) -> int:
        """MoE: only routed experts count."""
        if self.family != "moe":
            return self.params_count()
        d, n_l = self.d_model, self.n_layers
        dense = self.params_count() - \
            n_l * self.moe_experts * 3 * d * self.moe_dff
        return dense + n_l * self.moe_topk * 3 * d * self.moe_dff
