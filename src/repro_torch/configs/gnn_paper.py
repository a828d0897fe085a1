"""The paper's own model/dataset configurations (Table II/III)."""

GNN_MODELS = {
    "graphsage": {"layers": 3, "agg": "sum", "hidden": 128},
    "gcn": {"layers": 3, "agg": "avg", "hidden": 128},
}

FANOUTS = {"small": (2, 2, 2), "medium": (8, 4, 2), "large": (15, 10, 5)}
BATCH_SIZES = (256, 1024, 4096)
