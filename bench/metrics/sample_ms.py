"""Host time per batch in the sample stage outside its wait (``sync:num_unique``), in
ms: the ``sample`` spans' self time, from the program's spans (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    s = spans.summary()
    if s is None or "sample" not in s["stages"]:
        return None
    return spans.self_ms(s, ("sample",)) / spans.items(s)
