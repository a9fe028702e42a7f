"""Split-replay partition planning: adaptive device/server segmentation of a
recorded inference operator sequence (partial offloading on top of RRTO's
record/replay engine), ported from ``repro.partition``."""
from repro_torch.partition.adaptive import AdaptiveReplanner, ReplannerStats
from repro_torch.partition.pipeline import (
    PipelineSchedule,
    PipelineSimulation,
    Stage,
    pipeline_schedule,
    simulate_pipeline,
    stage_chain,
)
from repro_torch.partition.planner import (
    EvaluatedPlan,
    PartitionConfig,
    evaluate_plan,
    plan_cost,
    plan_partition,
)
from repro_torch.partition.segments import (
    PLACE_DEVICE,
    PLACE_SERVER,
    ConstantLink,
    NetworkLink,
    Schedule,
    Segment,
    SegmentGraph,
    SplitPlan,
    compute_schedule,
)

__all__ = [
    "AdaptiveReplanner",
    "ReplannerStats",
    "EvaluatedPlan",
    "PartitionConfig",
    "PipelineSchedule",
    "PipelineSimulation",
    "Stage",
    "evaluate_plan",
    "pipeline_schedule",
    "plan_cost",
    "plan_partition",
    "simulate_pipeline",
    "stage_chain",
    "PLACE_DEVICE",
    "PLACE_SERVER",
    "ConstantLink",
    "NetworkLink",
    "Schedule",
    "Segment",
    "SegmentGraph",
    "SplitPlan",
    "compute_schedule",
]
