"""The one traffic generator: a cell's frames from its configuration, its
traffic mix and the run's seed.

A traffic mix (``traffic/<name>.json``) is data:

- ``frames``: the number of frame pairs in the cycle a caller runs through;
- ``lift_start``, ``lift_end``: frame ``k`` of ``F`` is the configuration's
  scene with its ``lift`` stepped evenly from ``lift_start`` (frame 0) to
  ``lift_end`` (frame ``F - 1``);
- ``callers`` (1) and ``think_s`` (0): a closed loop, each call made as the
  previous one returns;
- ``entry``: the call the window makes, ``calls/<entry>.py``;
  ``reference``: the plain reference its answers are held to,
  ``reference/<reference>.py``; either may also be the configuration's;
- ``call``: keyword arguments of the entry point beyond the
  configuration's own;
- ``trace_cycles``, ``breakdown_cycles`` and ``sync_cycles``: whole cycles
  a traced run profiles for the device's time, for the host's labels of
  its idle gaps, and counts host syncs over.

The configuration (``configs/<name>.json``) gives the scene under
``scene``; its ``kind`` names the module ``scenes/<kind>.py`` that makes it,
with ``topology(scene)`` and ``frame(topology, scene, spec, rng)``.  Every
frame draws its random numbers from ``(seed, k)``; the topology is built
once and shared, as a simulation's mesh keeps it.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from ccd_bench import cells

__all__ = ["Cycle", "make_cycle", "frame_specs", "frame_rng", "call_options"]


class Cycle(NamedTuple):
    """The frames one caller runs through, in order, again and again."""

    v0: list          # float64 (n, 3) per frame
    v1: list
    edges: np.ndarray  # int32 (m, 2), shared
    faces: np.ndarray  # int32 (k, 3), shared
    specs: list        # each frame's spec: {"lift": ...}

    @property
    def n_vf_boxes(self) -> int:
        return len(self.v0[0]) + len(self.faces)

    @property
    def n_ee_boxes(self) -> int:
        return len(self.edges)


def frame_rng(seed: int, k: int) -> np.random.Generator:
    """The random stream of frame ``k`` of a run seeded with ``seed`` (any
    Python int: it is taken modulo 2^64)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), int(k)]))


def frame_specs(traffic: dict) -> list:
    """Each frame's spec: its lift, stepped evenly from ``lift_start`` to
    ``lift_end``."""
    n = int(traffic["frames"])
    a, b = float(traffic["lift_start"]), float(traffic["lift_end"])
    return [{"lift": a + (b - a) * k / max(n - 1, 1)} for k in range(n)]


def make_cycle(config: dict, traffic: dict, seed: int, base: Path = cells.BASE) -> Cycle:
    sc = config["scene"]
    if traffic.get("callers", 1) != 1 or traffic.get("think_s", 0) != 0:
        raise ValueError("the generator makes one closed-loop caller with no think time")
    kind = cells.load_module(base, "scenes", sc["kind"])
    topo = kind.topology(sc)
    specs = frame_specs(traffic)
    v0, v1 = [], []
    for k, spec in enumerate(specs):
        a, b = kind.frame(topo, sc, spec, frame_rng(seed, k))
        v0.append(a)
        v1.append(b)
    return Cycle(v0, v1, topo.edges, topo.faces, specs)


def call_options(config: dict, traffic: dict) -> dict:
    """The entry point's keyword arguments: the configuration's ``call``,
    then the traffic's."""
    return {**config.get("call", {}), **traffic.get("call", {})}
