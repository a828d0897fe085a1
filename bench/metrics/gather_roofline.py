"""The feature gathers' share of their roofline, in %: the least time for the rows
the window's gathers had to move (``bench/roofline.py``, from row and hit counts)
over the device time of the port's gather kernels in the profiler trace."""

from bench.roofline import gather_bytes, least_seconds

# The kernels of src/repro_torch/csrc/cached_gather.cu.
KERNELS = ("gather_rows_kernel", "gather_blocks_kernel", "gather_select_kernel")


def read(ctx):
    trace, groups = ctx.get("trace"), ctx.get("gather_groups")
    if not trace or not groups:
        return None
    seconds = sum(s for name, s in trace["kernel_s"].items() if any(k in name for k in KERNELS))
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(*gather_bytes(groups)) / seconds
