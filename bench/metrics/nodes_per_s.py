"""Seed nodes whose logits the window produced, over the window's host-clock seconds.
Offline: every seed of every batch the window ran; layer-wise: every node of every pass."""


def read(ctx):
    out = ctx["outcome"]
    if out.window_s <= 0:
        return None
    return out.nodes / out.window_s
