"""Host time per executor item in a GAT layer's ``attend`` and ``project`` spans (the
``model`` lane: folding the score vectors and launching the attention kernel; the
heads' maps, the bias and the skip), in ms: their self time, from the program's
spans (``bench/spans.py``).  Nothing to read where the run recorded no such span."""

from bench import spans

NAMES = ("attend", "project")


def read(ctx):
    s = spans.summary()
    if s is None or not any(n in s["stages"] for n in NAMES):
        return None
    return spans.self_ms(s, NAMES) / spans.items(s)
