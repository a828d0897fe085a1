from repro_torch.graph.csc import AdjCache, CSCGraph, build_adj_cache, two_level_sort
from repro_torch.graph.datasets import DATASETS, DatasetSpec, SyntheticGraphDataset, load_dataset
from repro_torch.graph.features import FeatureStore, build_feature_cache, plain_feature_store
from repro_torch.graph.sampling import (
    BlockSample,
    DeviceGraph,
    count_visits,
    device_graph,
    sample_blocks,
    sample_neighbors,
)
from repro_torch.graph.shard import (
    ShardedFeatureStore,
    ShardPlan,
    make_shard_plan,
    partition_feature_store,
)

__all__ = [
    "AdjCache",
    "CSCGraph",
    "build_adj_cache",
    "two_level_sort",
    "DATASETS",
    "DatasetSpec",
    "SyntheticGraphDataset",
    "load_dataset",
    "FeatureStore",
    "build_feature_cache",
    "plain_feature_store",
    "BlockSample",
    "DeviceGraph",
    "count_visits",
    "device_graph",
    "sample_blocks",
    "sample_neighbors",
    "ShardedFeatureStore",
    "ShardPlan",
    "make_shard_plan",
    "partition_feature_store",
]
