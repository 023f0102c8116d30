"""Narrow phase: query data, tolerances, error filters and the bisection
rules (the solvers are in :mod:`scalable_ccd_tpu_torch.ops.solver`)."""

from scalable_ccd_tpu_torch.narrow_phase.oracle import ccd_query_oracle
from scalable_ccd_tpu_torch.narrow_phase.root_finder import (
    BisectStep,
    bisect_step,
    inclusion,
)
from scalable_ccd_tpu_torch.narrow_phase.types import (
    CCDQueries,
    compute_tolerance,
    concat_frames,
    domain_corners,
    gather_ee_queries,
    gather_vf_queries,
    numerical_error_bound,
    pack_edge_table,
    pack_face_table,
)

__all__ = [
    "BisectStep",
    "CCDQueries",
    "bisect_step",
    "ccd_query_oracle",
    "compute_tolerance",
    "concat_frames",
    "domain_corners",
    "gather_ee_queries",
    "gather_vf_queries",
    "inclusion",
    "numerical_error_bound",
    "pack_edge_table",
    "pack_face_table",
]
