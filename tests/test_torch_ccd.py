"""PyTorch port vs the JAX package: the chunked ``ccd()``, the IPC stepping
rule and the configuration, on the CPU.

The JAX side runs as its own suite runs it here (XLA ``fast`` sweep chunks,
the ``bfs`` queue solver).  Bars: TOI within 1e-7, equal candidate totals
and hit keys, equal ``ipc_refinements`` on the IPC rigs of
``tests/test_pipeline.py:175-258`` (run in f32).  Per-pair hit TOIs of the
port's two pipelines are compared with each other (the same plain solver);
against the JAX package they are held in ``test_torch_exact_modes.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu import CCDStats as JCCDStats
from scalable_ccd_tpu import ccd as jax_ccd
from scalable_ccd_tpu import ipc_ccd_strategy as jax_ipc
from scalable_ccd_tpu.config import CCDConfig as JCCDConfig
from scalable_ccd_tpu.config import MemoryConfig as JMemoryConfig
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.geometry.mesh import edges_from_faces
from scalable_ccd_tpu_torch import (
    CCDConfig,
    CCDStats,
    MemoryConfig,
    ccd,
    fused_ccd,
    ipc_ccd_strategy,
)
from scalable_ccd_tpu_torch.broad_phase import sort_boxes
from scalable_ccd_tpu_torch.geometry import aabb
from scalable_ccd_tpu_torch.interop import config_from_jax, from_numpy_scene
from scalable_ccd_tpu_torch.ops import sweep_ap

# the submodule, not the function of the same name that the package exports
port_ccd = importlib.import_module("scalable_ccd_tpu_torch.pipeline.ccd")

torch.set_num_threads(2)

F32 = jnp.float32
TINY = dict(box_chunk_size=8, pair_chunk_size=64)
CPU = dict(device="cpu")


def _args(s):
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


@pytest.fixture(scope="module")
def cloth():
    return jscenes.cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.5)


def _keys(pairs, n):
    return set(map(tuple, pairs[: int(n)].tolist()))


def test_sweep_chunks_retry_overflowing_chunks_once(monkeypatch, cloth):
    s = from_numpy_scene(cloth)
    vb = aabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    sb = sort_boxes(aabb.build_edge_boxes(vb, s.edges))
    whole, n_whole, _, _ = sweep_ap.sweep_pairs_reference(sb, False, 1 << 16)
    calls = []
    real = port_ccd.sweep_pairs

    def counted(sb_, two, budget, box_range):
        calls.append(budget)
        return real(sb_, two, budget, box_range=box_range)

    monkeypatch.setattr(port_ccd, "sweep_pairs", counted)
    got, total = set(), 0
    for pairs, count in port_ccd.sweep_chunks(sb, False, 64, 16):
        got |= _keys(pairs, count)
        total += count
    assert got == _keys(whole, n_whole) and total == int(n_whole)
    chunks = -(-sb.n // 64)
    assert len(calls) > chunks  # some chunks overflowed 16 rows ...
    assert all(b >= 16 for b in calls) and len(calls) <= 2 * chunks  # ... and retried once


@pytest.mark.parametrize("memory", [None, TINY], ids=["default", "tiny"])
def test_ccd_matches_jax(cloth, memory):
    jcfg = JCCDConfig(dtype="float32")
    if memory:
        jcfg = jcfg.replace(memory=JMemoryConfig(**memory))
    js, ps = JCCDStats(), CCDStats()
    ref = jax_ccd(*_args(cloth), config=jcfg, stats=js)
    got = ccd(*_args(cloth), config=config_from_jax(jcfg), stats=ps, **CPU)
    assert isinstance(got, float)
    assert got == pytest.approx(ref, abs=1e-7)
    assert (ps.vf_candidates, ps.ee_candidates) == (js.vf_candidates, js.ee_candidates)
    fused = fused_ccd(*_args(cloth), **CPU)
    assert ps.vf_candidates == int(fused.vf_total) and ps.ee_candidates == int(fused.ee_total)
    assert got == pytest.approx(float(fused.toi), abs=1e-7)
    assert ps.narrow_checks > 0 and ps.broad_time_s > 0 and ps.narrow_time_s > 0


def test_ccd_collisions_match_jax_and_fused(cloth):
    cfg = JCCDConfig(dtype="float32")
    hits_j, hits_p, hits_f = [], [], []
    ref = jax_ccd(*_args(cloth), config=cfg, collisions=hits_j)
    got = ccd(*_args(cloth), config=config_from_jax(cfg), collisions=hits_p, **CPU)
    res = fused_ccd(*_args(cloth), collisions=hits_f, **CPU)
    assert len(hits_j) > 0 and len(hits_p) == len(set((a, b) for a, b, _ in hits_p))
    assert sorted((a, b) for a, b, _ in hits_p) == sorted((a, b) for a, b, _ in hits_j)
    assert sorted(hits_p) == sorted(hits_f)  # one plain solver, the same per-pair TOIs
    assert got == pytest.approx(ref, abs=1e-7)
    assert got == pytest.approx(min(t for *_, t in hits_p), abs=0)
    assert got == pytest.approx(float(res.toi), abs=0)


def test_ccd_toi_per_query_config_keeps_the_toi(cloth):
    base = ccd(*_args(cloth), **CPU)
    assert ccd(*_args(cloth), config=CCDConfig(toi_per_query=True),
               **CPU) == pytest.approx(base, abs=1e-7)


def _rig(x, z=0.01):
    """A static unit triangle and a vertex ``z`` above it falling 0.03
    (crossing the plane at t = z / 0.03), offset by ``x``."""
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0 = np.concatenate([tri, [[0.25, 0.25, z]]]) + [x, 0.0, 0.0]
    v1 = v0.copy()
    v1[3, 2] -= 0.03
    return v0, v1


def test_ipc_refinement_is_per_chunk_like_jax():
    """``tests/test_pipeline.py:175-228`` in f32: benign clusters whose
    chunks have candidates and no contact, one contact rig in its own
    chunk.  The rig sits at x = 5 instead of 100: at x = 100 the f32 exact
    re-solve of the contact costs millions of checks, and the JAX queue
    solver spills its queue there (a conservative TOI of 0.2664062 against
    the exact 0.2665527)."""
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0_parts, v1_parts, face_parts, nv = [], [], [], 0
    for cx in (0.0, 10.0, 20.0, 30.0):
        v0_parts += [tri + [cx, 0.0, 0.0], tri + [cx, 0.0, 0.12]]
        v1_parts += [tri + [cx, 0.0, 0.0], tri + [cx, 0.0, 0.09]]
        face_parts += [np.arange(3) + nv, np.arange(3) + nv + 3]
        nv += 6
    rig0, rig1 = _rig(5.0)
    v0 = np.concatenate(v0_parts + [rig0])
    v1 = np.concatenate(v1_parts + [rig1])
    faces = np.stack(face_parts + [np.arange(3) + nv]).astype(np.int32)
    edges = edges_from_faces(faces)
    jcfg = JCCDConfig(dtype="float32", memory=JMemoryConfig(
        box_chunk_size=8, pair_chunk_size=1 << 12, query_buckets=(1 << 10,)))
    js, ps = JCCDStats(), CCDStats()
    ref = jax_ipc(v0, v1, edges, faces, min_distance=0.05, config=jcfg, stats=js)
    got = ipc_ccd_strategy(v0, v1, edges, faces, min_distance=0.05,
                           config=config_from_jax(jcfg), stats=ps, **CPU)
    assert ps.vf_candidates > 1  # benign chunks really had candidates
    assert ps.ipc_refinements == js.ipc_refinements == 1
    assert got == pytest.approx(ref, abs=1e-7)
    assert got == pytest.approx(0.8 / 3.0, rel=1e-3)
    assert ccd(v0, v1, edges, faces, min_distance=0.05, config=config_from_jax(jcfg),
               **CPU) < 1e-6


def test_ipc_fused_matches_chunked_like_jax():
    """``tests/test_pipeline.py:231-258`` in f32: one rig, one chunk and
    one batch, so both granularities refine once and agree."""
    v0, v1 = _rig(0.0)
    faces = np.arange(3, dtype=np.int32)[None]
    edges = edges_from_faces(faces)
    jcfg = JCCDConfig(dtype="float32", solver="bfs")
    js = JCCDStats()
    ref = jax_ipc(v0, v1, edges, faces, min_distance=0.05, config=jcfg, stats=js)
    cs, fs = CCDStats(), CCDStats()
    toi_c = ipc_ccd_strategy(v0, v1, edges, faces, min_distance=0.05, stats=cs, **CPU)
    toi_f = ipc_ccd_strategy(v0, v1, edges, faces, min_distance=0.05, stats=fs,
                             impl="fused", vf_budget=1 << 10, ee_budget=1 << 10, **CPU)
    assert cs.ipc_refinements == fs.ipc_refinements == js.ipc_refinements == 1
    assert toi_c == pytest.approx(ref, abs=1e-7)
    assert toi_f == pytest.approx(toi_c, abs=1e-7)
    assert toi_f == pytest.approx(0.8 / 3.0, rel=1e-3)


def test_ipc_strategy_on_a_cloth_matches_jax(cloth):
    """The stepping rule at its defaults (``max_iterations=1_000_000``)
    with a separation that refines nothing: both granularities give JAX's
    TOI."""
    jcfg = JCCDConfig(dtype="float32")
    ref = jax_ipc(*_args(cloth), min_distance=1e-3, config=jcfg)
    cs, fs = CCDStats(), CCDStats()
    toi_c = ipc_ccd_strategy(*_args(cloth), min_distance=1e-3, stats=cs, **CPU)
    toi_f = ipc_ccd_strategy(*_args(cloth), min_distance=1e-3, stats=fs, impl="fused", **CPU)
    assert cs.ipc_refinements == fs.ipc_refinements == 0
    assert toi_c == pytest.approx(ref, abs=1e-7)
    assert toi_f == pytest.approx(ref, abs=1e-7)
    assert 0.0 < toi_c < 1.0


def test_ipc_fused_falls_back_to_chunked_on_overflow(cloth, monkeypatch):
    """A fused run whose budgets overflow is answered by the chunked path
    (JAX ``ccd.py:493-497``)."""
    calls = []
    monkeypatch.setattr(port_ccd, "ccd", lambda *a, **k: calls.append(k) or 0.5)
    got = ipc_ccd_strategy(*_args(cloth), min_distance=1e-3, impl="fused",
                           vf_budget=16, ee_budget=16, **CPU)
    assert got == 0.5 and len(calls) == 1 and calls[0]["ipc_refine"]
    with pytest.raises(ValueError, match="impl"):
        ipc_ccd_strategy(*_args(cloth), impl="bogus", **CPU)


def test_profiler_scopes_of_ccd(cloth):
    """``SCALABLE_CCD_PROFILE=1`` (here :meth:`Profiler.enable`) records
    the scopes of ``ccd()``; off, nothing is recorded."""
    from scalable_ccd_tpu_torch.utils.profiler import profiler

    prof = profiler()
    prof.clear()
    ccd(*_args(cloth), **CPU)
    assert prof.data() == {}
    prof.enable()
    try:
        ccd(*_args(cloth), **CPU)
        tree = prof.data()["sccd.ccd"]
    finally:
        prof.disable()
        prof.clear()
    for name in ("sccd.upload", "sccd.boxes", "sccd.phase.vf", "sccd.phase.ee"):
        assert tree[name]["time_ms"] >= 0.0 and tree[name]["device"] is False
    assert tree["time_ms"] >= tree["sccd.phase.vf"]["time_ms"]


# ---- configuration ------------------------------------------------------------

def test_config_from_jax_round_trip():
    mem = JMemoryConfig(box_chunk_size=8, pair_chunk_size=64, query_buckets=(16, 32),
                        memory_limit_GB=4.0)
    jcfg = JCCDConfig(tolerance=1e-5, toi_per_query=True, presample=False, memory=mem)
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, CCDConfig) and isinstance(cfg.memory, MemoryConfig)
    for name in ("dtype", "precision", "tolerance", "max_iterations", "allow_zero_toi",
                 "toi_per_query", "presample", "broad_impl", "solver",
                 "escalate_rounds", "stack_capacity"):
        assert getattr(cfg, name) == getattr(jcfg, name)
    assert cfg.memory == config_from_jax(mem)
    assert cfg.memory.scaled() == MemoryConfig(**{
        k: getattr(jcfg.memory.scaled(), k) for k in MemoryConfig.__dataclass_fields__
    })
    assert config_from_jax(JCCDConfig()) == CCDConfig()


@pytest.mark.parametrize("bad, item", [
    (dict(dtype="float16"), "unknown dtype"),
    (dict(precision="f64"), "unknown precision"),
    (dict(escalate_rounds=(128, 32)), "ascending"),
    (dict(escalate_rounds=(-1, 32)), "negative"),
    (dict(solver="bfs"), "JAX package"),
    (dict(broad_impl="pallas"), "JAX package"),
    (dict(dtype="float64", precision="compensated"), "f64 already"),
])
def test_unported_config_values_raise(cloth, bad, item):
    with pytest.raises(ValueError, match=item):
        ccd(*_args(cloth), config=CCDConfig(**bad), **CPU)
    with pytest.raises(ValueError, match=item):
        ipc_ccd_strategy(*_args(cloth), config=CCDConfig(**bad), impl="fused", **CPU)
