"""paligemma-3b [vlm] — SigLIP patch prefix (STUB) + gemma decoder (MQA).

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=257216  [arXiv:2407.07726]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_ff=16384,
    vocab=257216, rope_theta=10_000.0, act="gelu", mlp_gated=True,
    tie_embeddings=True, frontend="image", frontend_seq=256,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="paligemma-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=128, vocab=256, frontend_seq=8)
