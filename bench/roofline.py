"""The least time a window's feature gathers could take on the card.

``chip_smoke.py``'s bound arithmetic: each hit row read once over HBM,
each miss row read once over PCIe from pinned host memory, each output
row written once over HBM with its 8 bytes of id and slot; the two links
run in parallel, so the least time is the larger of the two terms.  The
rates are the published ones of an H100 SXM (the "NVIDIA H100 80GB
HBM3"): HBM3 at 3.35 TB/s, PCIe Gen5 x16 at 64 GB/s each way.

The counts come from the window's rows and hits alone, not from what a
kernel did, so every gather route is held to the same bound.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PCIE_BYTES_PER_S", "gather_bytes", "least_seconds"]

HBM_BYTES_PER_S = 3.35e12
PCIE_BYTES_PER_S = 64e9
ID_BYTES_PER_ROW = 8  # an int32 id and an int32 cache slot


def gather_bytes(groups) -> tuple[int, int]:
    """``(hbm_bytes, pcie_bytes)`` over ``(hit_rows, miss_rows, row_bytes)``
    groups, one group per table the gathers read (the feature table; the
    layer-wise mode's embedding tables).  A group writes one output row
    per row it reads."""
    hbm = pcie = 0
    for hit_rows, miss_rows, row_bytes in groups:
        written = hit_rows + miss_rows
        hbm += (hit_rows + written) * row_bytes + ID_BYTES_PER_ROW * written
        pcie += miss_rows * row_bytes
    return hbm, pcie


def least_seconds(hbm_bytes: int, pcie_bytes: int) -> float:
    return max(hbm_bytes / HBM_BYTES_PER_S, pcie_bytes / PCIE_BYTES_PER_S)
