"""Preparation seconds of the prepared pipeline (``PreparedPipeline.prep_seconds``):
presampling's steady laps, Eq. 1 and the fill of both caches, host-timed by the program."""


def read(ctx):
    return ctx.get("prep_s")
