"""Architecture registry: ``get(name)`` -> full ModelConfig,
``get_smoke(name)`` -> reduced same-family config for CPU tests.

Every config of the reference registry (``repro/configs``), field for
field: the dense GQA models, the hybrid attention + SSM family, the MoE
family, the pure-SSM family, the encoder-decoder family and the VLM
family (paligemma, served as its text-only decoder, as the reference
serves it)."""
from __future__ import annotations

import importlib

ARCHS = (
    "mamba2_370m",
    "deepseek_coder_33b",
    "qwen1_5_0_5b",
    "starcoder2_7b",
    "phi3_medium_14b",
    "arctic_480b",
    "kimi_k2_1t_a32b",
    "whisper_base",
    "paligemma_3b",
    "hymba_1_5b",
)

# CLI ids (--arch) map dashes to underscores
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).smoke()


def all_archs():
    return list(ARCHS)
