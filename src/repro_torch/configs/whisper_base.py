"""whisper-base [audio] — encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed frame embeddings).

enc 6L + dec 6L d_model=512 8H d_ff=2048 vocab=51865  [arXiv:2212.04356]
"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, use_rope=False, norm="ln", act="gelu",
    mlp_gated=False, frontend="audio", frontend_seq=1500,
    tie_embeddings=True,
    max_position=65_536,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, enc_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, frontend_seq=16,
        max_position=512)
