"""Eq. 1's adjacency share of the cache budget, in %, from the prepared pipeline's
``allocation.adj_bytes / total_bytes``."""


def read(ctx):
    alloc = ctx.get("allocation")
    if not alloc or not alloc["total_bytes"]:
        return None
    return 100.0 * alloc["adj_bytes"] / alloc["total_bytes"]
