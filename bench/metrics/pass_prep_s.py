"""Seconds per layer-wise pass in its set-up: the ``plan``, ``probe``, ``refill``,
``spill-alloc``, ``warm`` and ``embed-fill`` spans, over the passes (one ``plan`` span
each), from the program's spans (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    s = spans.summary()
    if s is None or "plan" not in s["stages"]:
        return None
    total_ms = sum(s["stages"][n]["total_ms"] for n in spans.PASS_PREP if n in s["stages"])
    return total_ms / 1e3 / s["stages"]["plan"]["count"]
