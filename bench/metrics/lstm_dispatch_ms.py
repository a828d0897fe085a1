"""Host time per executor item in a GraphSAGE-LSTM layer's ``input-map``, ``recur`` and
``combine`` spans (the ``model`` lane: the gate rows' SGEMM; launching the recurrence
kernel; the self and neighbour maps, the concatenation and, after the last layer, the L2
norm and the output map), in ms: their self time, from the program's spans
(``bench/spans.py``).  Nothing to read where the run recorded no such span."""

from bench import spans

NAMES = ("input-map", "recur", "combine")


def read(ctx):
    s = spans.summary()
    if s is None or not any(n in s["stages"] for n in NAMES):
        return None
    return spans.self_ms(s, NAMES) / spans.items(s)
