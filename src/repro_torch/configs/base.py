"""Architecture/shape configuration schema.

Every assigned architecture provides an `ArchConfig` via
`repro.configs.registry.get_config(name)`; the same dataclass drives
model construction, parameter sharding, the dry-run input specs and the
smoke tests (through `reduced()`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell of the dry-run grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


def lm_shapes() -> Dict[str, ShapeSpec]:
    """The four assigned LM shapes (identical for all ten archs)."""
    return {
        "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
        "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
        "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
        "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
    }


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # dispatch locality: >1 computes expert positions per token block
    # (GShard per-device capacity; blocks align with the data shards)
    dispatch_blocks: int = 1
    # serving-path capacity factor; 0.0 -> drop-free (= n_experts)
    serve_capacity_factor: float = 0.0
    # "scatter" (baseline) | "einsum" (GShard one-hot matmul dispatch)
    dispatch_mode: str = "scatter"
    dispatch_group: int = 2048

    # attention pattern: per-layer sliding window, cycled over layers;
    # 0 = global attention. () = all-global.
    window_pattern: Tuple[int, ...] = ()
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    post_norm: bool = False  # gemma2-style post-block norms

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    d_inner_mult: int = 2
    attn_every: int = 0  # zamba2: shared attn after every N mamba layers

    # RWKV
    rwkv_head_dim: int = 64

    rope_theta: float = 10000.0
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scale
    tie_embeddings: bool = True
    frontend: str = "none"  # "vision_stub" | "audio_stub" (input = embeddings)
    subquadratic: bool = False  # supports long_500k
    norm_eps: float = 1e-6

    # documentation fields
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.d_inner_mult * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (drives the roofline MODEL_FLOPS)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + (
            self.n_heads * hd
        ) * d
        total = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            per_layer = attn
            if self.n_experts:
                per_layer += d * self.n_experts + self.n_experts * 3 * d * ff
            else:
                per_layer += 3 * d * ff
            total += self.n_layers * per_layer
        elif self.family == "hybrid":
            H = self.ssm_heads
            mamba = (
                self.d_model * (2 * self.d_inner + 2 * self.ssm_state + H)
                + self.d_inner * self.d_model
            )
            total += self.n_layers * mamba
            total += (self.n_layers // max(self.attn_every, 1)) * 0 + attn  # shared
        elif self.family == "ssm":
            total += self.n_layers * (6 * d * d + 2 * d * ff)  # rwkv approx
        total += V * d if self.tie_embeddings else 2 * V * d
        return total

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top_k experts count)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive = (self.n_experts - self.top_k) * 3 * d * ff * self.n_layers
        return self.param_count() - inactive

    def supported_shapes(self) -> Dict[str, ShapeSpec]:
        shapes = dict(lm_shapes())
        if not self.subquadratic:
            # long_500k needs sub-quadratic attention (docs/design.md §5).
            shapes.pop("long_500k")
        return shapes

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration of the same family (CPU-runnable)."""
        pattern_len = max(len(self.window_pattern), 1)
        n_layers = max(2, self.attn_every or 0, pattern_len)
        if self.attn_every:
            n_layers = 2 * self.attn_every
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            rwkv_head_dim=16,
            window_pattern=tuple(
                min(w, 8) if w else 0 for w in self.window_pattern
            ),
        )
