"""Pluggable server-side aggregation strategies (port of
``repro.core.aggregators``).  Importing this package registers the paper's
five methods (``florist``, ``fedit``, ``ffa``, ``flora``, ``flexlora``);
the reference's sharded ``florist_sharded`` raises ``NotImplementedError``
until the multi-device slice ports it."""
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
from repro_torch.core.aggregators.fedit import FedItAggregator
from repro_torch.core.aggregators.ffa import FfaAggregator
from repro_torch.core.aggregators.flexlora import FlexLoRAAggregator
from repro_torch.core.aggregators.flora import FloraAggregator
from repro_torch.core.aggregators.florist import FloristAggregator

#: the paper's five methods, in the paper's comparison order
METHODS = ("florist", "fedit", "ffa", "flora", "flexlora")

__all__ = [
    "AggResult", "Aggregator", "METHODS", "accepted_config",
    "adapter_leaf_paths", "available_aggregators", "bucket_by_shape",
    "fold_scale", "fresh_client_adapters", "get_aggregator_class", "get_path",
    "leaf_dims", "leaf_rank", "make_aggregator", "ones_scale",
    "register_aggregator", "set_path", "FedItAggregator", "FfaAggregator",
    "FlexLoRAAggregator", "FloraAggregator", "FloristAggregator",
]
