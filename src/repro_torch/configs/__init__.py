"""Architecture registry: ``get(name)`` -> full ModelConfig,
``get_smoke(name)`` -> reduced same-family config for CPU tests.

Lists the architectures the port has a config for: those it serves today
(dense GQA, the hybrid attention + SSM family, the MoE family, the
pure-SSM family and the encoder-decoder family) and deepseek-coder-33b,
whose smoke config the fp8 KV-cache tests need (its full-width serve is
still to come); the reference's other three wait for their slices (see
ROADMAP.md)."""
from __future__ import annotations

import importlib

ARCHS = (
    "qwen1_5_0_5b",
    "hymba_1_5b",
    "arctic_480b",
    "kimi_k2_1t_a32b",
    "whisper_base",
    "mamba2_370m",
    "deepseek_coder_33b",
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
