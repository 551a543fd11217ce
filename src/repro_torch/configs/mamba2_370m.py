"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=0,
    vocab=50280, use_rope=False,
    ssm_state=128, d_ssm_head=64, ssm_expand=2, ssm_conv=4, ssm_chunk=64,
    tie_embeddings=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=128,
        ssm_state=16, d_ssm_head=16, ssm_chunk=8)
