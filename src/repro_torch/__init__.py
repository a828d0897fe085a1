"""PyTorch/CUDA port of the DCI dual-cache GNN inference system.

A package beside the JAX reference (``src/repro``), module for module at
the same subpaths.  It imports ``torch`` and ``numpy`` and never the JAX
package; the pure-Python modules it needs from there are carried over as
copies.  The feature gather runs through hand-written CUDA kernels
(``kernels/cached_gather``, source in ``csrc/cached_gather.cu``); every
entry point runs on the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
