"""Model configuration (port of ``repro/models/config.py``).

Same fields and defaults as the reference ``ModelConfig`` so a config
built here describes the same model; the dtype properties return torch
dtypes.  The port serves every family of the reference (see
``configs``).
"""
from __future__ import annotations

import dataclasses

import torch


def torch_dtype(name: str) -> torch.dtype:
    """Dtype name as used by the reference configs ("bfloat16",
    "float32", "float8_e4m3fn", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = global attention
    global_every: int = 0          # hybrid: every k-th layer is global
    # normalization / mlp
    norm: str = "rms"              # rms | ln
    norm_eps: float = 1e-5
    act: str = "silu"              # silu | gelu
    mlp_gated: bool = True
    tie_embeddings: bool = False
    # positional fallback when use_rope=False
    max_position: int = 32_768

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    moe_dense_residual: bool = False
    router_scale: float = 1.0

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    d_ssm_head: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # encoder-decoder / multimodal frontend
    enc_layers: int = 0
    frontend: str = ""
    frontend_seq: int = 0

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_dtype: str = ""             # KV-cache storage ("" = compute dtype)

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def kv_dtype_name(self) -> str:
        return self.kv_dtype or self.compute_dtype

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def kvdtype(self) -> torch.dtype:
        return torch_dtype(self.kv_dtype_name)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as the
        reference counts it."""
        d, f, V = self.d_model, self.d_ff, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        if not self.use_rope and self.family == "encdec":
            emb += self.max_position * d  # learned positions
        per_attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        per_mlp = d * f * (3 if self.mlp_gated else 2)
        per_moe = 0
        if self.is_moe:
            e = self.d_expert or f
            per_moe = (d * self.n_experts
                       + self.n_experts * d * e * 3
                       + self.n_shared_experts * d * e * 3)
        per_ssm = 0
        if self.has_ssm:
            di = self.d_inner_ssm
            ns = self.ssm_heads
            per_ssm = d * 2 * di + di * d + d * (2 * self.ssm_state) \
                + di * self.ssm_conv + 2 * ns + di
        blocks = 0
        for li in range(self.n_layers):
            blocks += per_attn if self.has_attention else 0
            blocks += per_ssm if self.has_ssm else 0
            if self.is_moe and li >= self.n_dense_layers:
                blocks += per_moe + (per_mlp if self.moe_dense_residual
                                     else 0)
            else:
                blocks += per_mlp if f else 0
        enc = 0
        if self.enc_layers:
            enc = self.enc_layers * (per_attn + per_mlp) \
                + self.n_layers * per_attn  # decoder cross-attention
        return emb + blocks + enc

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts
        only)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        e = self.d_expert or self.d_ff
        inactive = (self.n_experts - self.top_k) * d * e * 3 \
            * (self.n_layers - self.n_dense_layers)
        return self.n_params() - inactive
