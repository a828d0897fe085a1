"""Host time per executor item outside its waits, in ms: the self time of ``admit``,
the stage spans and ``retire`` (their wait spans taken out), from the program's spans
(``bench/spans.py``)."""

from bench import spans


def read(ctx):
    s = spans.summary()
    if s is None:
        return None
    return spans.self_ms(s, spans.DISPATCH) / spans.items(s)
