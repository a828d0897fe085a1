from repro_torch.models.gnn.models import MODELS, forward, forward_layer, init_params

__all__ = ["MODELS", "forward", "forward_layer", "init_params"]
