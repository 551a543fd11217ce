"""deepseek-coder-33b [dense] — llama-arch GQA.

62L d_model=7168 56H (kv=8) d_ff=19200 vocab=32256  [arXiv:2401.14196]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab=32256, rope_theta=100_000.0, act="silu", mlp_gated=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128)
