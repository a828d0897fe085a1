"""CUDA kernel for blocked online-softmax attention (H100, sm_90a).

The wrapper around ``csrc/flash_attention.cu``, built with ``nvcc`` at
first use and loaded with ``ctypes`` (``kernels/_build.py``).  It
replaces the Pallas TPU kernel ``flash_attention_2d`` of the reference's
``src/repro/kernels/flash_attention/kernel.py`` together with the vmap
over (batch, head) in its ``ops.py``: :func:`flash_attention` takes
``q [B, Hq, Sq, D]`` and ``k, v [B, Hkv, Sk, D]`` with ``Hq % Hkv == 0``
and covers them in ONE launch, query head ``h`` reading kv head
``h // (Hq / Hkv)``.  Causal and window masks are aligned at position 0 for
both sequences; ``softcap`` applies ``c * tanh(s / c)`` before the mask; a
row with no kept key outputs 0.  Scores and the accumulator are fp32; in
bfloat16 the probabilities are rounded to bfloat16 before the product
with ``v``.  What bounds it is operations; the source note in the ``.cu``
file says what this first, simple design does (fp32 FMA, no tensor
cores, no TF32 rounding of the float32 path).

Routing: on CPU tensors the wrappers compute the plain version
(``ref.py``); on CUDA tensors they launch the kernel or raise — there is
no fallback.  ``flash_attention.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

__all__ = ["MAX_HEAD_DIM", "flash_attention", "flash_attention_2d", "load_library"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("flash_attention")
    lib = ctypes.CDLL(str(path))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.dci_flash_attention.argtypes = [p, p, p, p, i, i, i, ll, ll, i, i, f, i, i, ll, i, f, p]
    lib.dci_flash_attention.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Multi-head attention, ``[B, Hq, Sq, D]`` out, in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, Hq, Sq, D] and k, v [B, Hkv, Sk, D] of one shape")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not fit "
                         "(batch and D must match, Hq a multiple of Hkv)")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if q.device.type == "cpu":
        if k.device.type != "cpu" or v.device.type != "cpu":
            raise ValueError("q, k and v must share one device")
        return attention_ref(q, expand_kv(k, hq), expand_kv(v, hq),
                             causal=causal, window=window, softcap=softcap)
    if not q.is_cuda or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k and v must lie on one CUDA device, got {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim D={d} is not supported: the kernel takes 1 <= D <= "
                         f"{MAX_HEAD_DIM}")
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the kernel's grid limit of 65535")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    if sk == 0:  # every row fully masked
        return out.zero_()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # The scale in q's dtype, as the reference computes it.
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=q.dtype))
    status = load_library().dci_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hq // hkv, sq, sk, d,
        _DTYPES[q.dtype], scale, int(causal), int(window is not None),
        0 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(f"dci_flash_attention launch failed: CUDA error {status}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_2d(
    q: torch.Tensor,  # [Sq, D]
    k: torch.Tensor,  # [Sk, D]
    v: torch.Tensor,  # [Sk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """One head: the reference's ``flash_attention_2d``, ``[Sq, D]`` out."""
    if q.dim() != 2 or k.dim() != 2 or v.dim() != 2:
        raise ValueError("flash_attention_2d takes 2-D q [Sq, D], k and v [Sk, D]")
    return flash_attention(q[None, None], k[None, None], v[None, None],
                           causal=causal, window=window, softcap=softcap)[0, 0]
