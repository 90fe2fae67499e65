"""Federated round runtime (port of ``repro.core.runtime``): the client
runner (``sequential``), the round scheduler (``sync``) and rank policy
(``static``), the measured wire transport (``fp32`` and ``bf16`` codecs)
and the validation gate (``off`` / ``screen``).  Other names raise
``NotImplementedError`` until a later slice ports them."""
from repro_torch.core.runtime.runners import (ClientRunner, SequentialRunner,
                                              available_runners, make_runner)
from repro_torch.core.runtime.schedulers import (ClientTask, RankPolicy,
                                                 RoundPlan, RoundScheduler,
                                                 StaticRankPolicy,
                                                 SyncScheduler,
                                                 available_schedulers,
                                                 make_rank_policy,
                                                 make_scheduler)
from repro_torch.core.runtime.transport import (AdapterPayload, Codec,
                                                EncodedArray, PayloadCorrupted,
                                                PayloadError, Transport,
                                                available_codecs, make_codec,
                                                make_transport)
from repro_torch.core.runtime.validation import (GateStats, ValidationGate,
                                                 make_validator)

__all__ = [
    "AdapterPayload", "ClientRunner", "ClientTask", "Codec", "EncodedArray",
    "GateStats", "PayloadCorrupted", "PayloadError", "RankPolicy",
    "RoundPlan", "RoundScheduler", "SequentialRunner", "StaticRankPolicy",
    "SyncScheduler", "Transport", "ValidationGate", "available_codecs",
    "available_runners", "available_schedulers", "make_codec",
    "make_rank_policy", "make_runner", "make_scheduler", "make_transport",
    "make_validator",
]
