"""Federated round runtime (port of ``repro.core.runtime``): pluggable
client runners (``sequential``, ``cohort``, ``sharded_cohort``), round schedulers (``sync``,
``partial``, ``async``, ``sampled``) and rank policies (``static``,
``resource``), the measured wire transport (``fp32``, ``bf16`` and
``int8`` codecs, local DP on the uplink, bounded retries), deterministic
fault injection (:class:`FaultPlan`, :class:`SimClock`, server crash
points) and the validation gate (``off`` / ``screen`` / ``full``)."""
from repro_torch.core.runtime.faults import (CRASH_POINTS, Fault, FaultPlan,
                                             ServerCrash, SimClock)
from repro_torch.core.runtime.runners import (ClientRunner, CohortRunner,
                                              SequentialRunner,
                                              ShardedCohortRunner,
                                              available_runners, make_runner)
from repro_torch.core.runtime.schedulers import (AsyncScheduler, ClientTask,
                                                 PartialScheduler, RankPolicy,
                                                 ResourceRankPolicy,
                                                 RoundPlan, RoundScheduler,
                                                 SampledScheduler,
                                                 StaticRankPolicy,
                                                 SyncScheduler,
                                                 available_rank_policies,
                                                 available_schedulers,
                                                 make_rank_policy,
                                                 make_scheduler,
                                                 register_rank_policy,
                                                 register_scheduler)
from repro_torch.core.runtime.transport import (AdapterPayload, Codec,
                                                DeadClientError, EncodedArray,
                                                PayloadCorrupted,
                                                PayloadError, Transport,
                                                TransportStats,
                                                available_codecs, make_codec,
                                                make_transport)
from repro_torch.core.runtime.validation import (GateStats, ValidationGate,
                                                 make_validator)

__all__ = [
    "AdapterPayload", "AsyncScheduler", "CRASH_POINTS", "ClientRunner",
    "ClientTask", "Codec", "CohortRunner", "DeadClientError", "EncodedArray",
    "Fault", "FaultPlan", "GateStats", "PartialScheduler", "PayloadCorrupted",
    "PayloadError", "RankPolicy", "ResourceRankPolicy", "RoundPlan",
    "RoundScheduler", "SampledScheduler", "SequentialRunner", "ServerCrash",
    "ShardedCohortRunner",
    "SimClock", "StaticRankPolicy", "SyncScheduler", "Transport",
    "TransportStats", "ValidationGate", "available_codecs",
    "available_rank_policies", "available_runners", "available_schedulers",
    "make_codec", "make_rank_policy", "make_runner", "make_scheduler",
    "make_transport", "make_validator", "register_rank_policy",
    "register_scheduler",
]
