"""Fault tolerance for single-device runs: supervision, straggler policy
and elastic rescale."""
from repro_torch.distributed.fault_tolerance import (
    GrownDataPlane,
    SegmentSupervisor,
    StragglerPolicy,
    StragglerRescale,
    SurvivorDataPlane,
    TrainSupervisor,
    regrow_plane,
    rescale_plan,
    run_elastic,
    run_elastic_auto,
    shrink_plane,
    suggest_commit_every,
)

__all__ = [
    "StragglerPolicy",
    "StragglerRescale",
    "TrainSupervisor",
    "SegmentSupervisor",
    "SurvivorDataPlane",
    "GrownDataPlane",
    "rescale_plan",
    "shrink_plane",
    "regrow_plane",
    "run_elastic",
    "run_elastic_auto",
    "suggest_commit_every",
]
