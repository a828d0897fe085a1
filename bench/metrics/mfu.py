"""The whole step's share of the card's peak, in %: the model's FLOPs in the window
(``bench/flops.py``, from the blocks' shapes) over the traced window times the
published float32 peak of 67 TFLOP/s (the port computes in float32 with TF32 off)."""

from bench.flops import FP32_PEAK


def read(ctx):
    trace, flops = ctx.get("trace"), ctx.get("flops")
    if not trace or not flops or trace["window_s"] <= 0:
        return None
    return 100.0 * flops / (trace["window_s"] * FP32_PEAK)
