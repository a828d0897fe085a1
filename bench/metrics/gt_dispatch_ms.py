"""Host time per executor item in a Graph Transformer layer's ``query``, ``attend``,
``project`` and ``gate`` spans (the ``model`` lane: the destinations' queries and their
fold through the key maps; launching the attention kernel; the heads' value maps and the
skip; the gate, the mix and LayerNorm), in ms: their self time, from the program's spans
(``bench/spans.py``).  Nothing to read where the run recorded no such span."""

from bench import spans

NAMES = ("query", "attend", "project", "gate")


def read(ctx):
    s = spans.summary()
    if s is None or not any(n in s["stages"] for n in ("query", "gate")):
        return None
    return spans.self_ms(s, NAMES) / spans.items(s)
