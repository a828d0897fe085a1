"""Wait spans per executor item: whole-device synchronizes and blocking reads from the
card, counted exactly from the program's spans (``bench/spans.py``)."""

from bench import spans


def read(ctx):
    s = spans.summary()
    if s is None:
        return None
    return s["waits"] / spans.items(s)
