"""Pluggable server-side aggregation strategies (port of
``repro.core.aggregators``).  Importing this package registers ``florist``;
the reference's other methods (``fedit``, ``ffa``, ``flora``, ``flexlora``)
raise ``NotImplementedError`` until a later slice ports them."""
from repro_torch.core.aggregators.base import (AggResult, Aggregator,
                                               accepted_config,
                                               adapter_leaf_paths,
                                               available_aggregators,
                                               bucket_by_shape, fold_scale,
                                               fresh_client_adapters,
                                               get_aggregator_class, get_path,
                                               leaf_dims, leaf_rank,
                                               make_aggregator, ones_scale,
                                               register_aggregator, set_path)
from repro_torch.core.aggregators.florist import FloristAggregator

__all__ = [
    "AggResult", "Aggregator", "accepted_config", "adapter_leaf_paths",
    "available_aggregators", "bucket_by_shape", "fold_scale",
    "fresh_client_adapters", "get_aggregator_class", "get_path", "leaf_dims",
    "leaf_rank", "make_aggregator", "ones_scale", "register_aggregator",
    "set_path", "FloristAggregator",
]
