"""RRTO serving in the port (``repro.serving``).

* :class:`~repro_torch.serving.engine.LocalServing`,
  :class:`~repro_torch.serving.engine.RRTOServedLM` and
  :class:`~repro_torch.serving.engine.MultiClientServedLM` — LM generation,
  local and through the offloading stack;
* :class:`~repro_torch.serving.multitenant.RRTOEdgeServer` — the shared edge
  server and its cooperative multi-client round loop;
* :class:`~repro_torch.serving.replay_cache.ReplayCache` — the
  content-addressed cache of replay programs;
* :class:`~repro_torch.serving.fleet.EdgeFleet` — N replicated edge servers
  behind a hedged, affinity-placing router, with cache replication,
  carried-state migration and crash recovery;
* :class:`~repro_torch.serving.recovery.SessionCheckpointer` — periodic
  carried-state checkpoints and bounded step replay;
* :class:`~repro_torch.serving.admission.AdmissionController` — per-tenant
  SLO classes, queue-limit and token-bucket admission, and the three-tier
  degradation ladder (overload protection).
"""
from repro_torch.distributed.straggler import AllReplicasFailedError, NoHealthyReplicaError
from repro_torch.serving.admission import (
    BRONZE,
    GOLD,
    SILVER,
    AdmissionController,
    AdmissionDecision,
    AdmissionRejectedError,
    AdmissionStats,
    SLOClass,
    TokenBucket,
)
from repro_torch.serving.engine import (
    GenerationResult,
    LocalServing,
    MultiClientServedLM,
    RRTOServedLM,
)
from repro_torch.serving.fleet import (
    CircuitBreaker,
    EdgeFleet,
    FleetClient,
    FleetReplica,
    FleetResult,
    FleetStats,
)
from repro_torch.serving.multitenant import ReplayBatcher, RRTOEdgeServer
from repro_torch.serving.recovery import CarriedCheckpoint, SessionCheckpointer
from repro_torch.serving.replay_cache import CacheStats, ReplayCache

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRejectedError",
    "AdmissionStats",
    "AllReplicasFailedError",
    "BRONZE",
    "CacheStats",
    "CarriedCheckpoint",
    "CircuitBreaker",
    "EdgeFleet",
    "FleetClient",
    "FleetReplica",
    "FleetResult",
    "FleetStats",
    "GOLD",
    "GenerationResult",
    "LocalServing",
    "MultiClientServedLM",
    "NoHealthyReplicaError",
    "ReplayBatcher",
    "ReplayCache",
    "RRTOEdgeServer",
    "RRTOServedLM",
    "SILVER",
    "SLOClass",
    "SessionCheckpointer",
    "TokenBucket",
]
