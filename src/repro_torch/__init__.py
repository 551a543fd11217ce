"""PyTorch/CUDA port of the MARS serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
relative module paths (``repro_torch/models/lm.py`` <-> ``repro/models/
lm.py``) and imports torch and numpy only — never jax, never ``repro``.

The ported slice is full-LM paged serving of a dense GQA model:
``python -m repro_torch.launch.serve --paged --config qwen1_5_0_5b``.
Every decode step's attention runs through the hand-written Hopper
kernel ``csrc/paged_attention.cu`` (``kernels/paged_attention``); on CPU
tensors each kernel wrapper runs its plain PyTorch twin instead.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is asked for but absent — nothing falls back to the CPU.
"""
