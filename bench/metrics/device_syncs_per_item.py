"""Whole-device synchronizes per executor item: the wait spans whose ``wait`` arg is
``device``, counted exactly from the program's spans (``bench/spans.py``).  None where
the program's spans give no such count."""

from bench import spans


def read(ctx):
    s = spans.summary()
    if s is None or "device_syncs" not in s:
        return None
    return s["device_syncs"] / spans.items(s)
