"""Fault tolerance for single-device and mesh runs: supervision, straggler
policy and elastic rescale (``multihost`` re-forms a mesh run's group)."""
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
    run_elastic_regrown,
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
    "run_elastic_regrown",
    "suggest_commit_every",
]
