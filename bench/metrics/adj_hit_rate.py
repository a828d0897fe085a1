"""Adjacency-cache hits over lookups in the window, in %, from the program's exact counts."""


def read(ctx):
    hits = ctx.get("hits")
    if not hits or not hits["adj_lookups"]:
        return None
    return 100.0 * hits["adj_hits"] / hits["adj_lookups"]
