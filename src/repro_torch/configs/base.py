"""Model/experiment configuration system.

One frozen dataclass describes every supported architecture family (dense /
MoE / SSM / hybrid / enc-dec / VLM); per-arch modules in this package
instantiate it with published hyperparameters.  ``reduced()`` derives the
small-config variant used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # --- attention features ---
    qk_norm: bool = False
    attn_softcap: float = 0.0       # gemma2 attention-logit softcap
    logit_softcap: float = 0.0      # gemma2 final-logit softcap
    window_pattern: tuple = ()      # per-layer 'L'(ocal)/'G'(lobal), tiled over depth
    window_size: int = 4096
    rope_theta: float = 10_000.0
    mlp_gated: bool = True          # SwiGLU vs plain GELU MLP

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0               # routed-expert hidden dim
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_seq: int = 0                # encoder frame count (audio frontend stub)

    # --- modality frontends (stubs per assignment spec) ---
    frontend: str = ""              # '' | 'audio' | 'vision'
    frontend_seq: int = 0           # patch/frame tokens prepended (vision)
    frontend_dim: int = 0           # raw embedding dim before projection

    # --- ternary / T-SAR ---
    ternary: bool = True
    lut_block_c: int = 4

    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    notes: str = ""

    # ----- derived -----
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Embedding-table size: vocab rounded up so the vocab axis shards
        cleanly on the 16-wide model axis (padded logits masked in the head).
        Standard practice (Megatron pads vocab to a multiple of 128*TP)."""
        mult = 2048 if self.vocab_size > 2048 else 16
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k-token decode: SSM/hybrid or local-window attention."""
        if self.family in ("ssm", "hybrid"):
            return True
        return bool(self.window_pattern) and "L" in self.window_pattern

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_is_global(self, i: int) -> bool:
        if not self.window_pattern:
            return True
        return self.window_pattern[i % len(self.window_pattern)] == "G"

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for rooflines."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = (d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                + (self.n_heads * hd) * d) if self.n_heads else 0
        mlp = (3 if self.mlp_gated else 2) * d * f if f else 0
        if self.is_moe:
            de = self.d_expert or f
            routed = self.n_experts * 3 * d * de
            shared = self.n_shared_experts * 3 * d * de
            router = d * self.n_experts
            mlp = routed + shared + router
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * ns + nh) + di * d + di  # in/out proj + conv-ish
        per_layer = {
            "dense": attn + mlp, "moe": attn + mlp, "vlm": attn + mlp,
            "ssm": ssm, "hybrid": attn + mlp + ssm,
            "encdec": attn + mlp,
        }[self.family]
        total = self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * (2 * d * self.n_kv_heads * hd + d * self.n_heads * hd + self.n_heads * hd * d)
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE top-k counting) for MODEL_FLOPS."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        de = self.d_expert or self.d_ff
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        active_mlp = (self.moe_top_k + self.n_shared_experts) * 3 * d * de + d * self.n_experts
        total = self.n_layers * (attn + active_mlp)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            window_size=32,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            frontend_seq=min(self.frontend_seq, 16) if self.frontend_seq else 0,
            frontend_dim=min(self.frontend_dim, 64) if self.frontend_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.family in ("ssm", "hybrid") else self.ssm_head_dim,
            ssm_chunk=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            d_expert=64 if self.d_expert else 0,
            name=self.name + "-reduced",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
