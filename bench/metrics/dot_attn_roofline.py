"""The Graph Transformer's attention kernel's share of its roofline, in %: the least
bytes the window's attention had to move (``attend_bytes`` of the configuration's model
file, every layer of every batch; layer 0 reads the window's distinct frontier rows,
counted by the reference's replay) at HBM3's 3.35 TB/s, over the device time of the
port's ``dot_attend`` kernel in the profiler trace.  Nothing to read where the model has
no such count or the trace no such kernel."""

from bench.reference import frontier_sizes
from bench.roofline import HBM_BYTES_PER_S

KERNEL = "dot_attend_kernel"  # src/repro_torch/csrc/dot_attend.cu


def read(ctx):
    trace, groups, model = ctx.get("trace"), ctx.get("gather_groups"), ctx.get("model")
    attend_bytes = getattr(model, "attend_bytes", None)
    if not trace or not groups or attend_bytes is None:
        return None
    seconds = sum(s for name, s in trace["kernel_s"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    config, batch = ctx["config"], ctx["mix"]["batch_size"]
    batches = ctx["outcome"].nodes // batch
    dims = model.dims(config)
    sizes = frontier_sizes(batch, config["fanouts"])
    n_layers = len(config["fanouts"])
    total = 0
    for li in range(n_layers):
        l = n_layers - 1 - li
        dst, positions = sizes[l], sizes[l + 1]
        indexed = li == 0 and config["dedup"]
        if indexed:
            distinct = sum(hit + miss for hit, miss, _ in groups)  # summed over the batches
        else:
            distinct = positions * batches
        total += attend_bytes(dims[li], dims[li + 1], config=config, layer=li, dst=dst * batches,
                              positions=positions * batches, distinct_rows=distinct,
                              indexed=indexed)
    return 100.0 * total / HBM_BYTES_PER_S / seconds
