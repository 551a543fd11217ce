"""Blockwise (flash) attention (port of ``repro/kernels/flash_attention/
flash_attention.py``).

``flash_attention`` is the wrapper around the hand-written Hopper kernel
``csrc/flash_attention.cu`` (which replaces the Pallas ``_kernel`` /
``flash_attention``; the source comment there gives its bound and
design).  On CUDA tensors it launches the kernel or raises — there is no
fallback; on CPU tensors it runs ``flash_attention_plain``, the kernel's
plain PyTorch twin, which the CPU tests and ``chip_smoke.py`` compare
against.  ``flash_attention.launches`` counts kernel launches.

The port's ``layers.sdpa`` routes here every attention whose mask is
none or plain causal with as many queries as keys.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 112, 128)
_MAX_BATCH_HEADS = 65535          # the kernel's grid y


def _check(q, k, v, causal: bool) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         f"(B, Sq, H, D) and (B, Sk, H, D)")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal flash_attention needs as many queries as keys, got "
            f"Sq={q.shape[1]}, Sk={k.shape[1]} (the reference kernel and "
            f"its oracle disagree on the query offset there)")


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """The kernel's plain twin: one softmax over every key in float32
    (masked scores -1e30), the probabilities rounded to v's dtype before
    the product with v, the sum in float32 divided by ``max(l, 1e-30)``,
    the result in q's dtype.  Same contract as ``flash_attention``."""
    _check(q, k, v, causal)
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s.mul_(1.0 / math.sqrt(q.shape[-1]))
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril_()
        s.masked_fill_(~keep, NEG_INF)
    s.sub_(s.amax(-1, keepdim=True)).exp_()
    l = s.sum(-1, keepdim=True)                        # (B, H, Sq, 1)
    acc = torch.einsum("bhqk,bkhd->bqhd", s.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30).transpose(1, 2)).to(q.dtype)


def _library() -> ctypes.CDLL:
    """The kernel's shared library (built at first use), with the C
    signature declared."""
    lib = build.load("flash_attention")
    fn = lib.mars_flash_attention
    if fn.argtypes is None:               # first use: declare once
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        err = lib.mars_cuda_error_string
        err.restype, err.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def _launch(q, k, v, causal: bool):
    """Check operands and launch the CUDA kernel on the current stream."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel built for head_dim in "
                         f"{HEAD_DIMS}; got {D}")
    if B * H > _MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention kernel takes B * H <= "
                         f"{_MAX_BATCH_HEADS}; got {B * H}")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mars_flash_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), B, H, Sq, Sk, D, int(causal), 1.0 / math.sqrt(D),
        stream)
    if rc != 0:
        why = lib.mars_cuda_error_string(rc).decode() if rc > 0 \
            else "unsupported"
        raise RuntimeError(f"flash_attention kernel launch failed: rc={rc} "
                           f"({why})")
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (B, Sq, H, D) in q's dtype:
    ``softmax(q k^T / sqrt(D)) v`` per batch and head, with no mask or,
    when ``causal``, key <= query (which needs Sq == Sk).  Any sequence
    lengths; no GQA (repeat K/V heads first).

    CUDA tensors launch the Hopper kernel (float32 or bfloat16, one dtype,
    contiguous, head dim in ``HEAD_DIMS``); CPU tensors run the plain
    twin."""
    _check(q, k, v, causal)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


flash_attention.launches = 0
