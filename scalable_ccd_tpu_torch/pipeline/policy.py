"""The input policy every entry point shares: device, working dtype, mesh
upload, sorted phase boxes and the auto knobs, resolved as JAX ``fused_ccd``
resolves its own (``fused.py:96,132-170,1880-1947``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import merge_two_lists, sort_boxes
from scalable_ccd_tpu_torch.config import normalize_round_limits
from scalable_ccd_tpu_torch.geometry.aabb import (
    build_edge_boxes,
    build_face_boxes,
    build_vertex_boxes,
)
from scalable_ccd_tpu_torch.utils.pca import apply_pca

__all__ = ["AUTO_ESCALATE_ROUNDS", "CONGESTION_MIN_BOXES", "Knobs", "mesh_tensors", "pow2ceil",
           "resolve_auto_escalation", "resolve_device", "resolve_dtype", "resolve_knobs",
           "sorted_phases"]

#: the congestion threshold (VF boxes; per phase for presample): the
#: congestion ordering and the batch ladder switch on, presample and the
#: frame pool off (the JAX package's ``_AUTO_BUCKET_MIN_BOXES``)
CONGESTION_MIN_BOXES = 1 << 20

#: staged-escalation rounds of the auto policy (``_AUTO_ESCALATE_ROUNDS``)
AUTO_ESCALATE_ROUNDS = 128


class Knobs(NamedTuple):
    """The resolved policy of one call."""

    bucket_minor: bool
    #: -1 (one unbounded pass), a limit >= 0, or a ladder of limits
    escalate_rounds: object
    #: "batch" (per-batch ladder) or "frame" (frame straggler pool)
    escalate_pool: str
    presample_vf: bool
    presample_ee: bool
    sweep_impl: str


def resolve_auto_escalation(escalate_rounds, max_iterations: int,
                            plain_f32: bool = True, cuda: bool = False):
    """``escalate_rounds`` with auto (``None`` or the config sentinel -2)
    resolved: :data:`AUTO_ESCALATE_ROUNDS` on the global path, off with a
    check cap (``_resolve_auto_escalation``, JAX ``fused.py:135-147``), and
    off unless the request is plain f32 (``plain_f32``): for f64 and for the
    compensated precision the JAX package solves with its queue solver,
    which does not escalate (``fused.py:1869-1883``).  ``cuda`` (a call of
    ``fused_ccd`` on a CUDA device) turns it off too: escalation splits
    shallow queries from deep ones because the TPU kernel's lanes run in
    lockstep, and kernel B's unbounded form shares a deep query's domains
    between the lane groups of its block instead."""
    if escalate_rounds is not None and escalate_rounds != -2:
        return escalate_rounds
    return AUTO_ESCALATE_ROUNDS if max_iterations < 0 and plain_f32 and not cuda else -1


def resolve_dtype(dtype):
    """``torch.float32`` or ``torch.float64`` from either, or from the
    strings ``"float32"`` and ``"float64"``; anything else raises."""
    names = {"float32": torch.float32, "float64": torch.float64}
    dtype = names.get(dtype, dtype)
    if dtype not in names.values():
        raise ValueError(f"unknown dtype {dtype!r}: float32 or float64")
    return dtype


def resolve_knobs(n_vf: int, n_ee: int, *, bucket_minor="auto", escalate_rounds=None,
                  escalate_pool="auto", sweep_impl: str = "pairs",
                  max_iterations: int = -1, collisions: bool = False,
                  ipc_refine: bool = False, plain_f32: bool = True,
                  presample="auto", cuda: bool = False) -> Knobs:
    """The auto policies as functions of the phases' box counts ``n_vf``
    (vertices + faces) and ``n_ee`` (edges), as JAX ``fused_ccd`` resolves
    them (``fused.py:1880-1947``): congestion ordering from
    :data:`CONGESTION_MIN_BOXES` VF boxes; escalation at 128 rounds on the
    global path; the frame pool below the threshold where its preconditions
    hold (global mode, one limit), the batch ladder otherwise; presample per
    phase below the threshold.  Unless ``plain_f32`` (an f64 or compensated
    request) auto escalation is off and the auto pool is the batch ladder.
    With ``cuda`` (``fused_ccd`` on a CUDA device) auto escalation is off
    too, and so the auto pool is the batch path, unless ``escalate_pool``
    is given: an explicit pool asks for escalation, and its auto rounds
    resolve as without ``cuda``.
    An explicit ``escalate_pool="frame"`` where the frame pool cannot run
    raises (the JAX package warns and takes the batch ladder).
    ``presample`` is ``"auto"`` (or ``None``), a bool for both phases, or a
    ``(vf, ee)`` pair (JAX ``_resolve_auto_presample``, ``fused.py:150-170,
    1939-1947``, and ``fused_ccd_core``'s tuple, ``:1644-1648``)."""
    if sweep_impl not in ("pairs", "records"):
        raise ValueError(f"unknown sweep_impl {sweep_impl!r}: 'pairs' or 'records'")
    if escalate_pool not in ("auto", None, "batch", "frame"):
        raise ValueError(
            f"unknown escalate_pool {escalate_pool!r}: 'batch' (per-batch "
            "ladder) or 'frame' (frame straggler pool)"
        )
    congested = n_vf >= CONGESTION_MIN_BOXES
    if bucket_minor == "auto":
        bucket_minor = congested
    er = resolve_auto_escalation(escalate_rounds, max_iterations, plain_f32,
                                 cuda and escalate_pool in ("auto", None))
    normalize_round_limits(er)  # a bad ladder raises here
    frame_ok = (not collisions and not ipc_refine and max_iterations < 0
                and isinstance(er, int) and er >= 0)
    if escalate_pool in ("auto", None):
        escalate_pool = "frame" if frame_ok and not congested and plain_f32 else "batch"
    elif escalate_pool == "frame" and not frame_ok:
        raise ValueError(
            "escalate_pool='frame' needs the global path and one round limit: "
            f"got escalate_rounds={er!r}, max_iterations={max_iterations}, "
            f"collisions={collisions}, ipc_refine={ipc_refine}"
        )
    if presample in ("auto", None):
        presample = (n_vf < CONGESTION_MIN_BOXES, n_ee < CONGESTION_MIN_BOXES)
    elif isinstance(presample, (tuple, list)):
        if len(presample) != 2:
            raise ValueError(f"presample={presample!r}: a (vf, ee) pair, a bool or 'auto'")
    else:
        presample = (presample, presample)
    return Knobs(bool(bucket_minor), er, escalate_pool, bool(presample[0]),
                 bool(presample[1]), sweep_impl)


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _as_tensor(x, dtype, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """``device``, or CUDA when it is ``None``, whatever the inputs are; a
    CUDA device on a machine without CUDA raises (the plain versions run
    only where the caller asks for the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    return device


def mesh_tensors(vertices_t0, vertices_t1, edges, faces, device, pca: bool):
    """The mesh on ``device``: vertices in their input precision (f32 or
    f64), indices int32; rotated into principal axes if ``pca``."""
    v0 = vertices_t0 if torch.is_tensor(vertices_t0) else np.asarray(vertices_t0)
    vdt = torch.float64 if v0.dtype in (np.float64, torch.float64) else torch.float32
    v0 = _as_tensor(vertices_t0, vdt, device)
    v1 = _as_tensor(vertices_t1, vdt, device)
    if pca:
        v0, v1, _ = apply_pca(v0, v1)
    return v0, v1, _as_tensor(edges, torch.int32, device), _as_tensor(faces, torch.int32, device)


def sorted_phases(v0, v1, edges, faces, min_distance, dtype, bucket_minor: bool):
    """``(vf_sorted, ee_sorted)``: the boxes of the mesh inflated by
    ``min_distance``, in ``dtype``, sorted (in the congestion ordering if
    ``bucket_minor``): VF the vertices merged with the faces (two lists),
    EE the edges (one list)."""
    vb = build_vertex_boxes(v0, v1, inflation_radius=min_distance, dtype=dtype)
    vf = sort_boxes(merge_two_lists(vb, build_face_boxes(vb, faces)), axis=0,
                    bucket_minor=bucket_minor)
    return vf, sort_boxes(build_edge_boxes(vb, edges), axis=0, bucket_minor=bucket_minor)
