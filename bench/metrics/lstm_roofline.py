"""GraphSAGE-LSTM's recurrence kernel's share of its roofline, in %: for each layer, the
larger of its operations in the window (``recur_flops`` of the configuration's model file)
at float32's 67 TFLOP/s and the least bytes it had to move (``recur_bytes``; layer 0 reads
the window's distinct frontier rows, counted by the reference's replay) at HBM3's 3.35
TB/s, summed over the layers, over the device time of the port's ``lstm_agg`` kernel in the
profiler trace.  Nothing to read where the model has no such count or the trace no such
kernel."""

from bench.flops import FP32_PEAK
from bench.reference import frontier_sizes
from bench.roofline import HBM_BYTES_PER_S

KERNEL = "lstm_agg_kernel"  # src/repro_torch/csrc/lstm_agg.cu


def read(ctx):
    trace, groups, model = ctx.get("trace"), ctx.get("gather_groups"), ctx.get("model")
    recur_flops = getattr(model, "recur_flops", None)
    if not trace or not groups or recur_flops is None:
        return None
    seconds = sum(s for name, s in trace["kernel_s"].items() if KERNEL in name)
    if seconds <= 0:
        return None
    config, batch = ctx["config"], ctx["mix"]["batch_size"]
    batches = ctx["outcome"].nodes // batch
    sizes = frontier_sizes(batch, config["fanouts"])
    n_layers = len(config["fanouts"])
    least = 0.0
    for li in range(n_layers):
        l = n_layers - 1 - li
        rows, terms = sizes[l] * batches, (sizes[l + 1] - sizes[l]) * batches
        indexed = li == 0 and config["dedup"]
        distinct = sum(hit + miss for hit, miss, _ in groups) if indexed else terms
        moved = model.recur_bytes(rows, terms, config=config, distinct_rows=distinct,
                                  indexed=indexed)
        least += max(recur_flops(rows, terms, config=config) / FP32_PEAK,
                     moved / HBM_BYTES_PER_S)
    return 100.0 * least / seconds
