"""The program's own spans in a traced run, for the per-layer readers.

While the traced window's ``torch.profiler`` records, the port records its
spans into one tracer per profiler session
(``repro_torch.core.trace.profiler_session``).  :func:`summary` is that
session's ``summarize_trace``, or ``None`` where the run recorded no
executor item: a ``--trace 0`` run, or a program without such a session.
An *item* is one executor ``batch`` span: a batch in the offline cells, a
chunk of one layer in the layer-wise cell.  A *wait span* (``drain:*``,
``sync:*``) is one whole-device synchronize or one blocking read from the
card.
"""

from __future__ import annotations

__all__ = ["DISPATCH", "PASS_PREP", "items", "self_ms", "summary"]

# An item's host work: pulling it, its stages and its retire.
DISPATCH = ("admit", "sample", "prefetch", "feature", "gather", "compute", "retire")
# A layer-wise pass's set-up.
PASS_PREP = ("plan", "probe", "refill", "spill-alloc", "warm", "embed-fill")

_last: tuple = (None, -1, None)  # (tracer, events seen, summary)


def summary() -> dict | None:
    global _last
    try:
        from repro_torch.core.trace import profiler_session, summarize_trace
    except ImportError:
        return None
    tracer = profiler_session()
    if tracer is None:
        return None
    if _last[0] is tracer and _last[1] == len(tracer.events):
        return _last[2]
    s = summarize_trace(tracer.events)
    if "waits" not in s or not s["stages"].get("batch", {}).get("count"):
        s = None
    _last = (tracer, len(tracer.events), s)
    return s


def items(s: dict) -> int:
    return s["stages"]["batch"]["count"]


def self_ms(s: dict, names) -> float:
    """Summed self time (ms) of the spans named ``names``: each span's
    duration less what its children on its lane cover."""
    return sum(s["stages"][n]["self_ms"] for n in names if n in s["stages"])
