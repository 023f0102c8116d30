"""The plain solver's runaway guard (``ops/solver.py:MAX_STEPS``, kernel B's
``kMaxSteps``) on a scene where every exact search blows up.

One vertex falls straight through one triangle with a minimum separation of
0.1: the roots of the separation fill a volume, so no search ends on its
tolerances and each solver stops it with a conservative accept (the JAX
queue solver at its frontier capacity, kernel B and the plain frontier at
the guard).  With the guard lowered to 2^12 evaluations the port's CPU
frame ends in seconds, at the defaults (the frame pool's round-limited pass,
then the pool solved unbounded) and with ``escalate_rounds=-1`` (one
unbounded pass).  The capped TOI depends on the exploration order in every
solver, so it is held only to what a conservative accept guarantees: in
``[0, 0.45]``, 0.45 being where the vertex comes within 0.1 of the plane.
``solver_capped`` is set, as in JAX ``fused_ccd``'s run on the same scene.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd
from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.ops import solver

torch.set_num_threads(2)

MIN_DISTANCE = 0.1
#: the vertex reaches z = 0.1 at t = (1 - 0.1) / 2
CONTACT = 0.45


@pytest.fixture(scope="module")
def scene():
    v0 = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.2, 0.2, 1]], np.float64)
    v1 = v0.copy()
    v1[3, 2] = -1.0
    faces = np.array([[0, 1, 2]], np.int32)
    edges = np.array([[0, 1], [1, 2], [0, 2]], np.int32)
    return v0, v1, edges, faces


@pytest.fixture(scope="module")
def reference(scene):
    return jax_fused_ccd(*scene, min_distance=MIN_DISTANCE, dtype=jnp.float32)


@pytest.mark.parametrize("kw", [{}, {"escalate_rounds": -1}])
def test_guard_ends_a_runaway_minimum_separation_search(scene, reference, monkeypatch, kw):
    monkeypatch.setattr(solver, "MAX_STEPS", 1 << 12)
    t0 = time.perf_counter()
    res = fused_ccd(*scene, min_distance=MIN_DISTANCE, device="cpu", **kw)
    assert time.perf_counter() - t0 < 60
    assert bool(reference.solver_capped) and bool(res.solver_capped)
    assert 0.0 <= float(res.toi) <= CONTACT
    assert 0.0 <= float(reference.toi) <= CONTACT
    assert not bool(res.overflowed) and int(res.vf_total) == int(reference.vf_total) == 1
    assert int(res.total_checks) > 1 << 12


def test_guard_leaves_searches_under_it_unchanged(monkeypatch):
    """A search that ends under the guard gives the same TOI and checks
    with the guard at its default and one above the search's length, and
    only a guard below it flags overflow."""
    rng = np.random.default_rng(5)
    rows = torch.as_tensor(rng.uniform(-1, 1, (64, 31)), dtype=torch.float32)
    rows[:, 24:27] = 1e-3
    rows[:, 27:30] = 1e-6
    rows[:, 30] = 0.0
    valid = torch.ones(64, dtype=torch.bool)
    toi, ovf, checks = solver.solve_packed_reference(rows, valid, True, 1.0, 1e-6)
    assert not bool(ovf) and int(checks) > 64
    monkeypatch.setattr(solver, "MAX_STEPS", int(checks) + 1)
    again = solver.solve_packed_reference(rows, valid, True, 1.0, 1e-6)
    assert (float(again[0]), bool(again[1]), int(again[2])) == (float(toi), False, int(checks))
    monkeypatch.setattr(solver, "MAX_STEPS", 2)
    low = solver.solve_packed_reference(rows, valid, True, 1.0, 1e-6)
    assert bool(low[1]) and float(low[0]) <= float(toi)
