"""Device resolution for every entry point of the port.

The port runs on a CUDA card unless the caller asks for the CPU: entry
points (``GNNInferenceEngine``, ``prepare``, ``DualCache.build`` and the
CLI) take a ``device`` argument that defaults to ``"cuda"``.  When no card
is present and the CPU was not asked for, they raise instead of quietly
carrying on on the host.  The dry-run's abstract trees live on ``"meta"``,
which only :func:`models.lm.model.init_params` accepts (``allow_meta``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "randn"]


def resolve_device(device: str | torch.device | None = None, *,
                   allow_meta: bool = False) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when no card is available,
    and ``ValueError`` for a device type other than CUDA or CPU (or
    ``"meta"`` with ``allow_meta``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu" and not (allow_meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    """float32 ``torch.randn`` from ``generator`` on the generator's own
    device; where ``device`` is ``"meta"``, an empty meta tensor of that
    shape: nothing is drawn and nothing allocated."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device)
