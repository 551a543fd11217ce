"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384 experts top-8,
one shared expert, first layer dense (paper-table config).

61L d_model=7168 64H (kv=8) d_ff=2048 vocab=163840  [arXiv:2501.kimi2]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840,
    n_experts=384, top_k=8, d_expert=2048, n_shared_experts=1,
    n_dense_layers=1,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="kimi-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=128, n_experts=8, top_k=2,
        d_expert=96, n_shared_experts=1, n_dense_layers=1)
