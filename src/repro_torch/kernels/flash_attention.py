"""Flash attention (forward) as a CUDA kernel (`csrc/flash_attention.cu`).

Replaces the TPU kernel
`repro/kernels/flash_attention.py::_flash_fwd_kernel`.  q [B, Hq, S, D]
attends over k, v [B, Hkv, Sk, D] with GQA, a causal mask, a sliding
window and a logit softcap, in fp32 online softmax; kv tiles outside
the causal diagonal or the window are skipped.  bfloat16 runs on the
tensor cores (wgmma; P as a hi/lo pair of bf16 values, so that the
output stays within one rounding of the plain version).  float32 with
D <= 128 runs on them too, as 3xTF32: each operand x as hi = tf32(x)
and lo = tf32(x - hi) (rounded to nearest, ties away), each product as
lo hi + hi lo + hi hi in fp32, behind a first kernel that writes K and
V^T as hi/lo halves into scratch allocated here; float32 with D > 128
runs on the CUDA cores.

`flash_attention_fwd` keeps the JAX signature (without `interpret`) and
refuses, with ValueError, what the JAX assertion refuses: Hq not a
multiple of Hkv, or S / Sk not a multiple of min(block_q, S) /
min(block_k, Sk).  `block_q` and `block_k` are checked only: the CUDA
kernel's tiles are constants of its source.  It runs
`flash_attention_plain` for CPU tensors and the kernel for CUDA tensors
(or raises); `launches` counts the launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mha_reference

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          scale=None):
    """The kernel's plain version: the reference math.  The Pallas kernel
    and the reference agree on fully masked rows (both give zeros)."""
    return mha_reference(q, k, v, causal=causal, window=window,
                         softcap=softcap, scale=scale)


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 5
        lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel reads 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, Sk, D]; returns [B, Hq, S, D] in
    q's dtype.  On the card: float32 or bfloat16, D a multiple of 8 up
    to 256."""
    global launches
    B, Hq, S, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv heads")
    bq, bk = min(block_q, S), min(block_k, Sk)
    if S % bq or Sk % bk:
        raise ValueError(f"S={S} / Sk={Sk} are not multiples of the blocks "
                         f"{bq} / {bk}")
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError("k and v must be [B, Hkv, Sk, D] with q's B and D")
    if D % 8 or D > 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8, at most 256")
    if B > 65535 or Hq > 65535:
        raise ValueError("B and Hq must be at most 65535 (grid axes)")
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, q on {dev}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if window is not None:
        # outside [-Sk, S] a window masks as its end point does
        window = max(-Sk, min(int(window), S))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lib = _lib()
    # the fp32 body's K and V^T as tf32 hi/lo halves
    nbytes = lib.flash_attention_scratch_bytes(B, Hkv, Sk, D, _DTYPES[q.dtype])
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, S, Sk, D, float(scale), float(softcap or 0.0),
        int(softcap is not None), int(causal), int(window is not None),
        int(window or 0), _DTYPES[q.dtype],
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "flash_attention_fwd")
    launches += 1
    return out
