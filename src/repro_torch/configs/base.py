"""Architecture configuration schema + the input-shape grid.

The port's copy of ``repro/configs/base.py`` (pure dataclasses, no
JAX).  One ``ArchConfig`` per assigned architecture (exact dims from the
assignment, ``configs/<id>.py``).  ``reduced()`` derives the family-preserving
small config used by the per-arch CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "MixerKind"]

MixerKind = Literal["full", "swa", "local", "ssm", "rglru"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One cell of the assignment's shape grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Transformer-family architecture description.

    ``layer_pattern`` lists the mixer of every layer in order; the model
    groups it into scannable segments of repeated units (DESIGN.md §5).
    """

    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[MixerKind, ...]
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    # --- attention variants ---
    window: int | None = None  # SWA window (applies to 'swa' mixers)
    local_window: int | None = None  # local-attention window ('local' mixers)
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_groups: int = 1
    ssm_expand: int = 2
    conv_kernel: int = 4
    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0
    # --- modality stubs ---
    modality: Literal["text", "vlm", "audio"] = "text"
    n_codebooks: int = 1  # audio: EnCodec streams
    vision_tokens: int = 0  # vlm: precomputed patch embeddings per sample
    # --- training ---
    tie_embeddings: bool = False
    # citation tag from the assignment
    source: str = ""

    def __post_init__(self):
        if len(self.layer_pattern) != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern length {len(self.layer_pattern)} != "
                f"n_layers {self.n_layers}"
            )

    # ---- derived quantities -------------------------------------------
    @property
    def attends_globally(self) -> bool:
        """True if any layer has unbounded attention (full, no window)."""
        return any(m == "full" for m in self.layer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic / bounded-state archs run long_500k."""
        return not self.attends_globally

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), for 6ND."""
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # unembed
        if self.modality == "audio" and self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * self.vocab_size * self.d_model
            total += (self.n_codebooks - 1) * self.vocab_size * self.d_model
        for mixer in self.layer_pattern:
            total += self._mixer_params(mixer) + self._mlp_params()
            total += 2 * self.d_model  # two rmsnorm scales
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only top_k experts)."""
        if not self.n_experts:
            return self.param_count()
        total = self.param_count()
        expert_p = 3 * self.d_model * self.d_ff
        n_moe_layers = self.n_layers
        total -= n_moe_layers * self.n_experts * expert_p
        total += n_moe_layers * self.top_k * expert_p
        return total

    def _mixer_params(self, mixer: str) -> int:
        d = self.d_model
        if mixer in ("full", "swa", "local"):
            q = d * self.n_heads * self.head_dim
            kv = 2 * d * self.n_kv_heads * self.head_dim
            o = self.n_heads * self.head_dim * d
            bias = (
                (self.n_heads + 2 * self.n_kv_heads) * self.head_dim
                if self.qkv_bias
                else 0
            )
            return q + kv + o + bias
        if mixer == "ssm":
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_p = d * (2 * di + 2 * self.ssm_groups * ns + nh)
            conv = self.conv_kernel * (di + 2 * self.ssm_groups * ns)
            extra = 2 * nh + di  # A_log, dt_bias, D, gated-norm scale
            out_p = di * d
            return in_p + conv + extra + out_p
        if mixer == "rglru":
            w = self.lru_width or d
            return 2 * d * w + self.conv_kernel * w + 3 * w + w * d
        raise ValueError(mixer)

    def _mlp_params(self) -> int:
        if self.n_experts:
            router = self.d_model * self.n_experts
            return router + self.n_experts * 3 * self.d_model * self.d_ff
        if self.d_ff == 0:  # attn-free mamba2: no separate MLP
            return 0
        return 3 * self.d_model * self.d_ff  # SwiGLU

    # ---- reduced config for smoke tests --------------------------------
    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for one-step CPU smoke tests."""
        n_layers = min(self.n_layers, 4)
        # keep the pattern's flavor: take a representative prefix
        pattern = self.layer_pattern[: n_layers]
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            layer_pattern=pattern,
            d_model=128,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 64) if self.window else None,
            local_window=min(self.local_window, 64) if self.local_window else None,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            # keep d_inner = ssm_heads · ssm_head_dim consistent
            ssm_head_dim=(self.ssm_expand * 128) // min(self.ssm_heads, 4)
            if self.ssm_heads
            else 0,
            ssm_groups=1,
            lru_width=128 if self.lru_width else 0,
            vision_tokens=min(self.vision_tokens, 16) if self.vision_tokens else 0,
        )
