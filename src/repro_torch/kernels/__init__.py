"""Hand-written CUDA kernels of the port (H100, sm_90a), one directory each.

Each directory keeps the reference's three files: ``kernel.py`` (the
wrappers, which launch the kernel on CUDA tensors and compute the plain
version on CPU tensors), ``ref.py`` (the plain torch version and oracle)
and ``ops.py`` (the public op with the reference's arguments).  Sources
live in ``src/repro_torch/csrc/`` and are built at first use
(``kernels/_build.py``); nothing here needs ``nvcc`` at import time.

  cached_gather/    DCI's two-source feature-row gather (hit -> hot table,
                    miss -> host table or the prefetched miss pack)
  seg_agg/          padded-neighbourhood aggregation (GNN sum/mean), and its
                    indexed form: a sampled GNN's first layer reading the
                    frontier's distinct rows through the inverse map
  flash_attention/  blocked online-softmax attention with causal,
                    sliding-window and logit-softcap variants
  gat_attend/       GAT's per-head softmax-weighted sums of a sampled layer's
                    input rows, scored from the heads' folded score vectors
                    (no reference counterpart, so no ``ops.py``)
  dot_attend/       the Graph Transformer's per-head softmax-weighted sums of a
                    sampled layer's neighbour rows, scored by each
                    destination's query folded through the key maps (no
                    reference counterpart, so no ``ops.py``)
  sample_layer/     one layer of DCI's neighbour sampling: slot draws, the
                    adjacency cache's hit test, the winning list's read and
                    the frontier's tail in one launch (the reference samples
                    in jnp ops, so no ``ops.py``)
"""

from repro_torch.kernels.cached_gather.ops import cached_feature_gather
from repro_torch.kernels.flash_attention.ops import multi_head_attention
from repro_torch.kernels.seg_agg.ops import aggregate_neighbors

__all__ = ["cached_feature_gather", "multi_head_attention", "aggregate_neighbors"]
