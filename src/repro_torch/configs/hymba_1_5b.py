"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer,
sliding-window attention with periodic global layers.

32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16
[arXiv:2411.13676]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, rope_theta=10_000.0,
    sliding_window=1024, global_every=16,
    ssm_state=16, d_ssm_head=64, ssm_expand=2, ssm_conv=4, ssm_chunk=64,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="hymba-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=128, sliding_window=16,
        global_every=2, ssm_state=8, d_ssm_head=16, ssm_chunk=8)
