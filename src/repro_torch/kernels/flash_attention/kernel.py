"""CUDA kernels for online-softmax attention (H100, sm_90a).

The wrapper around ``csrc/flash_attention.cu``, built with ``nvcc`` at
first use and loaded with ``ctypes`` (``kernels/_build.py``).  It
replaces the Pallas TPU kernel ``flash_attention_2d`` of the reference's
``src/repro/kernels/flash_attention/kernel.py`` together with the vmap
over (batch, head) in its ``ops.py``: :func:`flash_attention` takes
``q [B, Hq, Sq, D]`` and ``k, v [B, Hkv, Sk, D]`` with ``Hq % Hkv == 0``
and covers them in one call, query head ``h`` reading kv head
``h // (Hq / Hkv)``.  Causal and window masks are aligned at position 0 for
both sequences; ``softcap`` applies ``c * tanh(s / c)`` before the mask; a
row with no kept key outputs 0.  Scores and the accumulator are fp32; in
bfloat16 the probabilities are rounded to bfloat16 before the product
with ``v``.

Three designs (the source note in the ``.cu`` file says what bounds each
and what it does about it), chosen by :func:`plan` from the shapes:

* ``"split"`` — decode: at most ``SPLIT_MAX_ROWS`` query rows per kv head
  (``(Hq / Hkv) * Sq``).  The keys are split into chunks over CTAs that
  each serve a whole GQA group, then a second pass combines the chunks.
* ``"wgmma"`` — bfloat16 with ``D % 8 == 0`` otherwise: tensor cores fed
  by TMA.
* ``"fma"`` — everything else (float32 prefill, bfloat16 with another
  ``D``): fp32 FMA, so float32 never rounds through TF32.

Routing: on CPU tensors the wrappers compute the plain version
(``ref.py``); on CUDA tensors they launch the planned design or raise —
there is no fallback between designs.  ``flash_attention.launches``
counts the calls that launched, ``flash_attention.design_launches`` the
same calls by design.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention.ref import attention_ref, expand_kv

__all__ = ["DESIGNS", "MAX_HEAD_DIM", "Plan", "flash_attention", "flash_attention_2d",
           "load_library", "plan"]

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {"fma": 0, "wgmma": 1, "split": 2}
SPLIT_MAX_ROWS = 16  # query rows one split CTA serves: (Hq / Hkv) * Sq
SPLIT_TILE = 64  # keys the split kernel stages at a time; chunks are multiples of it
SPLIT_MAX_CHUNK = 512  # keys per chunk at most (the chunk's scores stay in shared memory)
SPLIT_CTAS_PER_SM = 4  # split CTAs per SM the chunking aims at


class Plan(NamedTuple):
    design: str  # "split", "wgmma" or "fma"
    chunk: int = 0  # split: keys per chunk
    n_chunks: int = 0  # split: chunks per (batch, kv head)


def plan(dtype: torch.dtype, b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
         sm_count: int) -> Plan:
    """The design a call takes, and the split's chunking.

    Split when a kv head meets at most ``SPLIT_MAX_ROWS`` query rows: a
    128-row query tile would then be mostly empty and each kv head would be
    read once per query head, while the split reads it once and spreads its
    keys over about ``SPLIT_CTAS_PER_SM`` CTAs per SM.  Otherwise bfloat16
    with ``D % 8 == 0`` (the TMA's 16-byte row stride) takes the tensor
    cores, and the rest the fp32 FMA kernel."""
    if (hq // hkv) * sq <= SPLIT_MAX_ROWS:
        per_head = -(-SPLIT_CTAS_PER_SM * sm_count // (b * hkv))
        chunk = -(-sk // max(per_head, 1))
        chunk = min(SPLIT_MAX_CHUNK, -(-chunk // SPLIT_TILE) * SPLIT_TILE)
        return Plan("split", chunk, -(-sk // chunk))
    if dtype == torch.bfloat16 and d % 8 == 0:
        return Plan("wgmma")
    return Plan("fma")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; declare its C ABI."""
    from repro_torch.kernels._build import build_library

    path, _ = build_library("flash_attention")
    lib = ctypes.CDLL(str(path))
    p, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.dci_flash_attention.argtypes = [p, p, p, p, i, i, i, ll, ll, i, i, f, i, i, ll, i, f,
                                        i, i, i, p, p]
    lib.dci_flash_attention.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scale(dtype: torch.dtype, d: int) -> float:
    """1/sqrt(D) in q's dtype, as the reference computes it."""
    return float(torch.tensor(1.0 / math.sqrt(d), dtype=dtype))


_STATUS = {-1: "the driver has no cuTensorMapEncodeTiled",
           -2: "the driver refused a TMA tensor map"}


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
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if out.numel() == 0:
        return out
    if sk == 0:  # every row fully masked
        return out.zero_()
    # Contiguous and 16-byte aligned (the TMA's and the 16-byte loads' rule).
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    route = plan(q.dtype, b, hq, hkv, sq, sk, d, _sm_count(q.device.index or 0))
    scratch = None
    if route.design == "split":
        rows = (hq // hkv) * sq
        scratch = torch.empty(b * hkv * route.n_chunks * rows * (d + 2), dtype=torch.float32,
                              device=q.device)
    status = load_library().dci_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hq // hkv, sq, sk, d,
        _DTYPES[q.dtype], _scale(q.dtype, d), int(causal), int(window is not None),
        0 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap), DESIGNS[route.design], route.chunk,
        route.n_chunks, None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if status != 0:
        what = _STATUS.get(status, f"CUDA error {status}")
        raise RuntimeError(f"dci_flash_attention ({route.design}) launch failed: {what}")
    flash_attention.launches += 1
    flash_attention.design_launches[route.design] += 1
    return out


flash_attention.launches = 0
flash_attention.design_launches = dict.fromkeys(DESIGNS, 0)


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
