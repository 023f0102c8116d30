"""State carried across between the JAX package and this port.

CCD has no weights; its state is the scene and the intermediate structures
(boxes, sorted boxes, queries).  These helpers turn values of the JAX
package, handed over as numpy arrays (``np.asarray`` of each field), into
this port's tensors, and the port's values back into numpy, so that a
single stage can be run on identical input in both packages, and turn a
JAX ``CCDConfig`` into the port's (:func:`config_from_jax`) and JAX
``fused_ccd`` and ``make_sharded_ccd`` options into the port's
(:func:`fused_kwargs_from_jax`, :func:`sharded_kwargs_from_jax`).  Nothing here
imports jax: the JAX-side values only need to convert with ``np.asarray``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from scalable_ccd_tpu_torch.broad_phase.sweep import SortedBoxes
from scalable_ccd_tpu_torch.config import CCDConfig, MemoryConfig
from scalable_ccd_tpu_torch.geometry.aabb import AABBs
from scalable_ccd_tpu_torch.narrow_phase.types import CCDQueries

__all__ = [
    "Scene",
    "from_numpy_scene",
    "from_numpy_boxes",
    "from_numpy_queries",
    "to_numpy",
    "config_from_jax",
    "fused_kwargs_from_jax",
    "sharded_kwargs_from_jax",
]

#: JAX ``sweep_impl`` values and the port's emission of the same pair set:
#: the record layouts place the same records on the TPU
_SWEEP_IMPL = {
    "xla": "pairs", "pallas_ap": "pairs", "pallas_rec": "records",
    "pallas_sparse": "records", "pallas_mxu": "records", "pallas_mxu16": "records",
}


class Scene(NamedTuple):
    """A two-frame mesh as tensors."""

    vertices_t0: torch.Tensor  # (n, 3) float64
    vertices_t1: torch.Tensor  # (n, 3) float64
    edges: torch.Tensor  # (m, 2) int32
    faces: torch.Tensor  # (k, 3) int32


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}.get(a.dtype, torch.int32)
    return torch.tensor(a, dtype=dtype, device=device)  # copies: a may be read-only


def from_numpy_scene(scene, device="cpu") -> Scene:
    """A scene object with ``vertices_t0``, ``vertices_t1``, ``edges`` and
    ``faces`` (either package's ``Scene``) as tensors."""
    return Scene(
        vertices_t0=_t(scene.vertices_t0, device, torch.float64),
        vertices_t1=_t(scene.vertices_t1, device, torch.float64),
        edges=_t(scene.edges, device, torch.int32),
        faces=_t(scene.faces, device, torch.int32),
    )


def from_numpy_boxes(boxes, device="cpu"):
    """JAX ``AABBs`` or ``SortedBoxes`` (fields as numpy arrays or anything
    ``np.asarray`` accepts) as the port's type of the same name; float
    fields keep their precision, integer fields become int32."""
    fields = boxes._fields
    cls = SortedBoxes if "major_min" in fields else AABBs
    return cls(*[_t(getattr(boxes, name), device) for name in cls._fields])


def from_numpy_queries(queries, device="cpu") -> CCDQueries:
    """JAX ``CCDQueries`` as the port's ``CCDQueries``."""
    return CCDQueries(*[_t(getattr(queries, name), device) for name in CCDQueries._fields])


def to_numpy(value):
    """A tensor, or a NamedTuple of tensors, as numpy (the same NamedTuple
    type holding numpy arrays)."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return type(value)(*[to_numpy(v) for v in value])


def config_from_jax(cfg):
    """A JAX ``CCDConfig`` or ``MemoryConfig`` as the port's dataclass of
    the same name, field by field (``dataclasses.fields``); the port's
    ``ccd()`` then rejects the values it lacks."""
    cls = CCDConfig if any(f.name == "memory" for f in dataclasses.fields(cfg)) else MemoryConfig
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)}
    if cls is CCDConfig:
        kw["memory"] = config_from_jax(cfg.memory)
    return cls(**kw)


def fused_kwargs_from_jax(**kwargs) -> dict:
    """JAX ``fused_ccd`` options as the port's: ``escalate_rounds``,
    ``escalate_pool``, ``bucket_minor``, ``precision``, ``presample`` (a
    bool, a ``(vf, ee)`` pair or auto) and ``narrow_batch`` carry over as
    they are (``None`` and ``"auto"`` mean auto in both), ``dtype`` (a
    numpy or jax.numpy scalar type, or its name) becomes ``"float32"`` or
    ``"float64"``, and ``sweep_impl`` maps to ``"pairs"`` (``xla``,
    ``pallas_ap``) or ``"records"`` (the record layouts).  Options that
    choose between the JAX package's own implementations (``solver``,
    ``narrow_order``, ...) have no counterpart and raise ``ValueError``."""
    out = {}
    for name, value in kwargs.items():
        if name in ("escalate_rounds", "escalate_pool", "bucket_minor", "precision",
                    "presample", "narrow_batch"):
            out[name] = value
        elif name == "dtype":
            out[name] = np.dtype(value).name
        elif name == "sweep_impl":
            if value not in _SWEEP_IMPL:
                raise ValueError(f"unknown JAX sweep_impl {value!r}")
            out[name] = _SWEEP_IMPL[value]
        else:
            raise ValueError(f"fused_ccd option {name!r} has no counterpart in the port")
    return out


#: ``make_sharded_ccd`` keywords of the JAX package that choose between its
#: TPU mechanisms, with the values that mean "its default": the port has one
#: mechanism for each, so only these values carry over (and are dropped)
_SHARDED_TPU_DEFAULTS = {
    "solver": ("auto",), "stack_capacity": (96,), "sweep_batch": (1 << 17,),
    "sweep_window": (32,), "shift_cap": (1 << 13,),
    # auto resolves to the sweep order on the sharded path (JAX sharded.py:95)
    "narrow_order": ("auto", "sweep"),
}

#: ``make_sharded_ccd`` keywords that carry over as they are
_SHARDED_AS_IS = (
    "vf_budget_per_shard", "ee_budget_per_shard", "max_iterations", "allow_zero_toi",
    "narrow_batch", "ipc_refine", "bucket_minor", "collect", "escalate_rounds", "presample",
    "precision", "partition", "halo_boxes",
)


def sharded_kwargs_from_jax(**kwargs) -> dict:
    """JAX ``make_sharded_ccd`` options as the port's
    :func:`scalable_ccd_tpu_torch.parallel.make_sharded_ccd`'s: the budgets
    per shard, ``partition``, ``halo_boxes``, ``collect`` and the options
    :func:`fused_kwargs_from_jax` passes on carry over as they are,
    ``dtype`` becomes its name, ``sweep_impl`` maps to ``"pairs"``
    (``pallas_ap``) or ``"records"`` (the record layouts) and its ``"auto"``
    to the port's default.  The TPU knobs (``solver``, ``stack_capacity``,
    ``sweep_batch``, ``sweep_window``, ``shift_cap``, ``narrow_order``) are
    dropped at their defaults and raise ``ValueError`` at any other value,
    as do ``sweep_impl="xla"`` (the XLA twin of the sweep, not a
    range-sharded kernel) and any unknown option."""
    out = {}
    for name, value in kwargs.items():
        if name in _SHARDED_AS_IS:
            out[name] = value
        elif name == "dtype":
            out[name] = np.dtype(value).name
        elif name == "sweep_impl":
            if value == "auto":
                continue
            if value == "xla" or value not in _SWEEP_IMPL:
                raise ValueError(f"sweep_impl={value!r} has no counterpart on the sharded path: "
                                 "'pallas_ap' (pairs) or a record layout (records)")
            out[name] = _SWEEP_IMPL[value]
        elif name in _SHARDED_TPU_DEFAULTS:
            if value not in _SHARDED_TPU_DEFAULTS[name]:
                raise ValueError(f"{name}={value!r} chooses a TPU mechanism the port does not "
                                 "have (docs/MIGRATION_TORCH.md)")
        else:
            raise ValueError(f"make_sharded_ccd option {name!r} has no counterpart in the port")
    return out
