"""starcoder2-7b [dense] — GQA, RoPE, non-gated GELU MLP, LayerNorm.

32L d_model=4608 36H (kv=4) d_ff=18432 vocab=49152  [arXiv:2402.19173]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, rope_theta=1_000_000.0, norm="ln", act="gelu",
    mlp_gated=False, qkv_bias=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128)
