"""arctic-480b [moe] — 128 experts top-2 with a parallel dense residual MLP.

35L d_model=7168 56H (kv=8) d_ff=4864 vocab=32000
[hf:Snowflake/snowflake-arctic-base]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000,
    n_experts=128, top_k=2, d_expert=4864, moe_dense_residual=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="arctic-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=128, n_experts=8, top_k=2, d_expert=96)
