"""Host time per executor item in wait spans (``drain:*``, ``sync:*``: the host blocked
on the card), in ms, from the program's spans (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    s = spans.summary()
    if s is None:
        return None
    return s["wait_ms"] / spans.items(s)
