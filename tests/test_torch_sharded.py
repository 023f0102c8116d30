"""The port's multi-device path (``parallel/sharded.py``) on the CPU.

Worlds of 1 (in this process), 2 and 4 CPU processes on gloo run every case
once per world (one spawn per world, shared by the module); every rank must
return the same result, and each case is held to JAX single-chip
``fused_ccd``, the JAX suite's bar for its sharded path
(``tests/test_fused_and_sharded.py:75-160``), and to the port's own
``fused_ccd(device="cpu")``: TOI within ``abs=1e-7``, pair totals exact, no
overflow.  The cases: both partitions at both ``sweep_impl``s, the forced
congestion ordering, f64, ``collect`` (hit keys equal to JAX
``fused_ccd(collisions=)``'s), the IPC rule (on the cloth, where it never
fires, and on the touching rig, where it fires once), a per-shard budget of
8 (which must overflow), the skewed-contacts scene of ``:486-541`` (stripes even to
within ``S`` rows, checks at most twice the single-process run) and the
sliver scene of ``:654-720``, whose minimum halo must overflow and whose
halo retry must recover the exact result.

The rank function builds its scenes with the port alone and imports no jax,
so the spawned processes stay light.
"""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.geometry.mesh import edges_from_faces
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
from scalable_ccd_tpu_torch.interop import sharded_kwargs_from_jax
from scalable_ccd_tpu_torch.parallel import make_sharded_ccd, sharded_ccd, spawn_local
from scalable_ccd_tpu_torch.parallel import sharded as sh
from scalable_ccd_tpu_torch.pipeline.policy import resolve_knobs, sorted_phases

torch.set_num_threads(2)

WORLDS = [1, 2, 4]
BUDGET = 1 << 12
#: small batches, so every rank runs several co-pruned batches and a presample
SHARD = dict(device="cpu", vf_budget_per_shard=BUDGET, ee_budget_per_shard=BUDGET,
             narrow_batch=256)


def _skewed():
    """A contact-rich cloth at x ~ 0 and 600 static triangles along +x, so
    most ranks' shares of the sorted order hold no contact (``:486-541``)."""
    cl = cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.6)
    v0, v1, f = [cl.vertices_t0], [cl.vertices_t1], [cl.faces]
    nv = v0[0].shape[0]
    tri = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.0, 0.2, 0.0]])
    for i in range(600):
        t = tri + [10.0 + 0.5 * i, 0.0, 0.0]
        v0.append(t)
        v1.append(t)
        f.append((np.arange(3) + nv)[None])
        nv += 3
    faces = np.concatenate(f).astype(np.int32)
    return np.concatenate(v0), np.concatenate(v1), edges_from_faces(faces), faces


def _sliver():
    """The row of triangles along x and the sliver reaching across it that
    drops into the row (``:654-720``), here 150 triangles from x = 10,
    beside a contact-rich cloth at x ~ 0: the cloth's early TOI prunes the
    sliver's long, coplanar queries, which the plain CPU solver would
    otherwise take minutes over.  The sliver's box still reaches across
    every rank's share, so a halo of one a-row is too short."""
    cl = cloth_on_sphere(grid_n=10, sphere_subdiv=1, drop=0.6)
    nv = cl.vertices_t0.shape[0]
    ntri = 150
    tri = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0], [0.0, 0.1, 0.0]])
    row = [tri + [10.0 + 0.5 * i, 0.0, 0.0] for i in range(ntri)]
    row.append(np.array([[10.0, 0.3, 0.0], [10.0 + 0.5 * ntri, 0.3, 0.0], [10.0, 0.35, 0.0]]))
    v0 = np.concatenate([cl.vertices_t0] + row)
    v1 = np.concatenate([cl.vertices_t1] + row)
    v1[-3:] -= [0.0, 0.27, 0.0]  # the sliver drops into the row
    faces = np.concatenate([cl.faces, nv + np.arange(3 * (ntri + 1)).reshape(-1, 3)])
    faces = faces.astype(np.int32)
    return v0, v1, edges_from_faces(faces), faces


def _rig():
    """The touching rig of ``tests/test_pipeline.py:231-258``: a static unit
    triangle and a vertex starting inside the 0.05 separation band, crossing
    the plane at t = 1/3.  Its one VF candidate lies in one rank's stripes,
    so the IPC rule fires on the reduced TOI in ranks that hold nothing."""
    tri = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    v0 = np.concatenate([tri, [[0.25, 0.25, 0.01]]])
    v1 = v0.copy()
    v1[3, 2] -= 0.03
    faces = np.arange(3, dtype=np.int32)[None]
    return v0, v1, edges_from_faces(faces), faces


def scene(name):
    """``(v0, v1, edges, faces)`` of a named scene, numpy, f64 vertices."""
    if name == "cloth":
        s = cloth_on_sphere(grid_n=16, sphere_subdiv=2, drop=0.3)
        return s.vertices_t0, s.vertices_t1, s.edges, s.faces
    return {"skewed": _skewed, "sliver": _sliver, "rig": _rig}[name]()


#: case -> (scene, sharded_ccd keywords); f32 unless the keywords say f64
CASES = {
    "pairs": ("cloth", {}),
    "records": ("cloth", dict(sweep_impl="records")),
    "box_pairs": ("cloth", dict(partition="box", halo_boxes=1 << 10)),
    "box_records": ("cloth", dict(partition="box", halo_boxes=1 << 10, sweep_impl="records")),
    "bucket_pairs": ("cloth", dict(bucket_minor=True)),
    "bucket_box_records": ("cloth", dict(bucket_minor=True, partition="box",
                                         halo_boxes=1 << 10, sweep_impl="records")),
    "f64": ("cloth", dict(dtype="float64")),
    "f64_box_records": ("cloth", dict(dtype="float64", partition="box", halo_boxes=1 << 10,
                                      sweep_impl="records")),
    "ipc_refine": ("cloth", dict(ipc_refine=True, min_distance=1e-3, max_iterations=100_000)),
    "ipc_rig": ("rig", dict(ipc_refine=True, min_distance=0.05)),
    "collect": ("cloth", dict(collect=True)),
    "collect_box_records": ("cloth", dict(collect=True, partition="box", halo_boxes=1 << 10,
                                          sweep_impl="records")),
    "budget8": ("cloth", dict(vf_budget_per_shard=8, ee_budget_per_shard=8)),
    "skewed": ("skewed", dict(dtype="float64", vf_budget_per_shard=1 << 14,
                              ee_budget_per_shard=1 << 14)),
    "sliver_box": ("sliver", dict(partition="box", halo_boxes=1,
                                  vf_budget_per_shard=1 << 14, ee_budget_per_shard=1 << 14)),
}


def _summary(res):
    return (float(res.toi), bool(res.overflowed), int(res.vf_total), int(res.ee_total),
            int(res.total_checks), bool(res.solver_capped), int(res.ipc_refinements))


def _run_case(name):
    """One case on this rank: ``(summary, extra)``."""
    scene_name, kw = CASES[name]
    kw = {**SHARD, **kw}
    ms = kw.pop("min_distance", 0.0)
    args = scene(scene_name)
    if kw.pop("collect", False):
        hits = []
        res = sharded_ccd(*args, min_distance=ms, collisions=hits, **kw)
        return _summary(res), hits
    if name == "sliver_box":
        # the minimum halo, straight through the step: it must overflow
        small = make_sharded_ccd(**kw)(*args)
        return _summary(sharded_ccd(*args, **kw)), _summary(small)
    res = sharded_ccd(*args, min_distance=ms, **kw)
    extra = None
    if name == "skewed":
        extra = _stripes(args, kw)
    return _summary(res), extra


def _stripes(args, kw):
    """Per phase of the skewed scene: this rank's own candidates, its
    stripes and the longest stripes of any rank."""
    comm = sh._Comm(sh.default_group(), torch.device("cpu"))
    v0, v1, e, f = sh.mesh_tensors(*args, torch.device("cpu"), False)
    knobs = resolve_knobs(v0.shape[0] + f.shape[0], e.shape[0], escalate_pool="batch")
    out = []
    for sb, is_vf in zip(sorted_phases(v0, v1, e, f, 0.0, torch.float64, False), (True, False)):
        rows = sh._owned_rows(sb.n, comm.rank, comm.world)
        pairs, n_true, _ = sh._shard_sweep(sb, is_vf, 1 << 14, knobs, rows)
        stripes, used = sh._balance(comm, pairs, False)
        out.append((int(n_true), stripes.shape[0], used))
    return out


def rank_cases(names):
    """Every case in ``names`` on this rank, in order."""
    torch.set_num_threads(1)
    return {name: _run_case(name) for name in names}


def _world_of_one(names):
    """The cases in a world of one process: this one, on gloo."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        try:
            return [rank_cases(names)]
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """``{world: [rank 0's results, ...]}``; the worlds run on first use."""
    cache = {}

    def get(world):
        if world not in cache:
            names = sorted(CASES)
            cache[world] = (_world_of_one(names) if world == 1
                            else spawn_local(world, rank_cases, names, backend="gloo"))
        return cache[world]

    return get


def _args(name, dtype):
    v0, v1, e, f = scene(name)
    return v0.astype(dtype), v1.astype(dtype), e, f


@pytest.fixture(scope="module")
def jax_ref():
    """JAX single-chip ``fused_ccd`` per reference key, computed once."""
    import jax.numpy as jnp

    from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd

    cache = {}

    def get(scene_name, f64=False, collect=False, **kw):
        """``kw``: the case's ``ipc_refine``, ``min_distance`` and
        ``max_iterations``, passed on."""
        key = (scene_name, f64, collect, tuple(sorted(kw.items())))
        if key not in cache:
            dt = jnp.float64 if f64 else jnp.float32
            hits = [] if collect else None
            res = jax_fused_ccd(*_args(scene_name, np.float64 if f64 else np.float32),
                                vf_budget=1 << 15, ee_budget=1 << 15, dtype=dt, collisions=hits,
                                **kw)
            cache[key] = (float(res.toi), bool(res.overflowed), int(res.vf_total),
                          int(res.ee_total), int(res.total_checks), hits)
        return cache[key]

    return get


@functools.lru_cache(maxsize=None)
def _port_ref(name):
    """The port's single-device ``fused_ccd(device="cpu")`` of a case, once."""
    scene_name, kw = CASES[name]
    dtype = kw.get("dtype", "float32")
    extra = {k: kw[k] for k in ("ipc_refine", "min_distance", "max_iterations") if k in kw}
    hits = [] if kw.get("collect") else None
    res = fused_ccd(*scene(scene_name), device="cpu", dtype=dtype, collisions=hits, **extra)
    return res, hits


def _replicated(out, name):
    """The case's result, after checking that every rank returned it."""
    first = out[0][name]
    for rank, r in enumerate(out[1:], 1):
        if name == "skewed":  # the stripes are per rank; the result is not
            assert r[name][0] == first[0], (name, rank)
        else:
            assert r[name] == first, (name, rank)
    return first


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["pairs", "records", "box_pairs", "box_records", "bucket_pairs",
                                  "bucket_box_records", "f64", "f64_box_records"])
def test_sharded_matches_single_device(runs, jax_ref, world, name):
    """Both partitions at both sweeps, the forced congestion ordering and
    f64: TOI within 1e-7 of JAX ``fused_ccd`` and of the port's, totals
    exact, no overflow, on every rank alike."""
    (toi, over, vf, ee, checks, capped, _), _ = _replicated(runs(world), name)
    f64 = CASES[name][1].get("dtype") == "float64"
    j = jax_ref("cloth", f64=f64)
    port, _ = _port_ref(name)
    assert not over and not j[1] and not capped
    assert toi == pytest.approx(j[0], abs=1e-7)
    assert toi == pytest.approx(float(port.toi), abs=1e-7)
    assert (vf, ee) == (j[2], j[3]) == (int(port.vf_total), int(port.ee_total))
    assert checks > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["collect", "collect_box_records"])
def test_sharded_collect_matches_single_device(runs, jax_ref, world, name):
    """``collect``: the replicated hit list has JAX ``fused_ccd(collisions=)``'s
    keys, in the port's order (VF first, each phase in id order), with the
    port's per-pair TOIs."""
    summary, hits = _replicated(runs(world), name)
    j = jax_ref("cloth", collect=True)
    port, port_hits = _port_ref(name)
    assert not summary[1]
    assert summary[0] == pytest.approx(j[0], abs=1e-7)
    assert sorted((a, b) for a, b, _ in hits) == sorted((a, b) for a, b, _ in j[5])
    assert [(a, b) for a, b, _ in hits] == [(a, b) for a, b, _ in port_hits]
    np.testing.assert_allclose([t for *_, t in hits], [t for *_, t in port_hits], rtol=0,
                               atol=1e-7)
    assert len(hits) > 0


def _ipc_case(runs, jax_ref, world, name):
    """An ``ipc_refine`` case against JAX ``fused_ccd`` with the case's
    keywords and against the port's: TOI within 1e-7 of both, totals
    exact, the port's count of refinements; returns that count."""
    (toi, over, vf, ee, _, _, refined), _ = _replicated(runs(world), name)
    scene_name, kw = CASES[name]
    j = jax_ref(scene_name, **{k: kw[k] for k in ("ipc_refine", "min_distance",
                                                  "max_iterations") if k in kw})
    port, _ = _port_ref(name)
    assert not over and not j[1]
    assert toi == pytest.approx(j[0], abs=1e-7)
    assert toi == pytest.approx(float(port.toi), abs=1e-7)
    assert (vf, ee) == (j[2], j[3]) == (int(port.vf_total), int(port.ee_total))
    assert refined == int(port.ipc_refinements)
    return refined


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ipc_refine_matches_single_device(runs, jax_ref, world):
    """The IPC rule on the cloth at a separation of 1e-3, where no batch
    reaches the rule's threshold: JAX's and the port's single-device TOI
    and totals, and no refinement."""
    assert _ipc_case(runs, jax_ref, world, "ipc_refine") == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ipc_refine_fires_on_the_reduced_toi(runs, jax_ref, world):
    """The touching rig: its one candidate sits in one rank's stripes, the
    rule fires once on the reduced TOI in every rank, and the result is
    JAX's and the port's 0.8 x the exact contact time 1/3."""
    assert _ipc_case(runs, jax_ref, world, "ipc_rig") == 1
    toi = _replicated(runs(world), "ipc_rig")[0][0]
    assert toi == pytest.approx(0.8 / 3.0, rel=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_budget_of_8_overflows(runs, jax_ref, world):
    (_, over, vf, ee, _, _, _), _ = _replicated(runs(world), "budget8")
    j = jax_ref("cloth")
    assert over
    # the totals stay exact past the budgets
    assert (vf, ee) == (j[2], j[3])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_skewed_contacts_balanced(runs, jax_ref, world):
    """Contacts in one rank's share: the stripes are even to within ``S``
    rows though the sweeps' shares are not, the result is single-chip's,
    and the co-pruning keeps the checks within twice the single-process
    run's."""
    out = runs(world)
    (toi, over, vf, ee, checks, _, _), _ = _replicated(out, "skewed")
    j = jax_ref("skewed", f64=True)
    single, _ = _port_ref("skewed")
    assert not over and not j[1]
    assert toi == pytest.approx(j[0], abs=1e-7)
    assert (vf, ee) == (j[2], j[3])
    assert checks <= 2 * int(single.total_checks)
    for phase in range(2):
        own = [r["skewed"][1][phase][0] for r in out]
        stripes = [r["skewed"][1][phase][1] for r in out]
        assert sum(own) == sum(stripes) == (vf, ee)[phase]
        assert max(stripes) - min(stripes) <= world
        assert all(r["skewed"][1][phase][2] == max(stripes) for r in out)
    if world > 1:
        assert max(r["skewed"][1][0][0] for r in out) > 2 * min(r["skewed"][1][0][0]
                                                               for r in out)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_halo_overflow_is_retried(runs, jax_ref, world):
    """The sliver reaches across the whole sorted axis: a halo of one
    a-row overflows on every rank but the last (never a silent drop), and
    ``sharded_ccd``'s retry recovers the exact single-chip result."""
    (toi, over, vf, ee, _, _, _), small = _replicated(runs(world), "sliver_box")
    j = jax_ref("sliver")
    assert not over and not j[1]
    assert toi == pytest.approx(j[0], abs=1e-7)
    assert (vf, ee) == (j[2], j[3])
    assert small[1] == (world > 1)


def test_partition_slice_sentinels_make_no_pairs():
    """Past the scene the slice holds sentinels: under ``any_order`` no row
    of them survives the row skip, and no sentinel forms a pair or a
    record, as a box or as a partner."""
    from scalable_ccd_tpu_torch.ops import sweep_ap, sweep_records

    v0, v1, e, f = (torch.as_tensor(a) for a in scene("cloth"))
    vf, _ = sorted_phases(v0, v1, e, f, 0.0, torch.float32, True)
    local, owned, ok = sh.partition_slice(vf, 1, 2, 1 << 10)
    real = vf.n - owned  # the scene's boxes in rank 1's slice; sentinels follow
    assert bool(ok) and local.n == owned + (1 << 10) > real
    planes = sweep_ap.partner_planes(local)
    real_rows = -(-real // sweep_ap.ROW)
    assert bool((planes.row_umin[real_rows:] > planes.row_umax[real_rows:]).all())
    pos = [(i, j) for i, j in sweep_ap.sweep_positions(local, True, any_order=True,
                                                       planes=planes) if j.numel()]
    assert pos and max(int(j.max()) for _, j in pos) < real
    recs, n_rec, _, _ = sweep_records.sweep_records_reference(local, True, 1 << 16,
                                                              any_order=True, planes=planes)
    recs = recs[: int(n_rec)].to(torch.int64)
    assert int(n_rec) > 0 and int(recs[:, 4].max()) < real
    assert int(recs[:, 5].max()) < real_rows


def test_sharded_needs_a_group_cuda_and_good_knobs():
    """No process group, a bad knob or, without CUDA, the default device
    raise before any collective."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_sharded_ccd(device="cpu")
    with pytest.raises(ValueError, match="partition"):
        make_sharded_ccd(partition="rows")
    with pytest.raises(ValueError, match="no auto budget"):
        make_sharded_ccd(vf_budget_per_shard="auto")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "store"),
                                world_size=1, rank=0)
        try:
            with pytest.raises(ValueError, match="sweep_impl"):
                make_sharded_ccd(device="cpu", sweep_impl="xla")
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="CUDA is not available"):
                    make_sharded_ccd()
        finally:
            dist.destroy_process_group()


def test_sharded_kwargs_from_jax():
    """``make_sharded_ccd``'s JAX keywords: the port's knobs carry over, the
    TPU knobs drop at their defaults and raise otherwise."""
    kw = sharded_kwargs_from_jax(
        vf_budget_per_shard=64, ee_budget_per_shard=32, sweep_impl="pallas_mxu16",
        solver="auto", narrow_order="auto", stack_capacity=96, partition="box",
        halo_boxes=256, dtype=np.float64, collect=True, bucket_minor="auto")
    assert kw == dict(vf_budget_per_shard=64, ee_budget_per_shard=32, sweep_impl="records",
                      partition="box", halo_boxes=256, dtype="float64", collect=True,
                      bucket_minor="auto")
    assert sharded_kwargs_from_jax(sweep_impl="auto") == {}
    for bad in (dict(narrow_order="key"), dict(sweep_impl="xla"), dict(solver="bfs"),
                dict(shift_cap=16), dict(mesh=None)):
        with pytest.raises(ValueError):
            sharded_kwargs_from_jax(**bad)


def test_dryrun_multichip_on_gloo(capsys):
    """The dry run (JAX ``__graft_entry__.py:48-93``) in two CPU ranks: a
    replicated and a ``partition="box"`` step agree, and the backend used
    is printed; a rank that raises fails the spawn with its traceback."""
    from scalable_ccd_tpu_torch.parallel import dryrun_multichip

    dryrun_multichip(2, backend="gloo", device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2, backend=gloo)" in out and "partition=box toi matches" in out
    with pytest.raises(RuntimeError, match="rank [01] of 2 .gloo. failed"):
        spawn_local(2, make_sharded_ccd, backend="gloo")  # device=None without CUDA


def test_partition_slice_holds_only_its_share():
    """A rank's slice is a copy of its ``L = C + H`` rows, sentinels
    included only past the scene: it keeps no view of the whole sorted
    arrays alive, and the halo test is the suffix minimum's."""
    v0, v1, e, f = (torch.as_tensor(a) for a in scene("cloth"))
    vf, _ = sorted_phases(v0, v1, e, f, 0.0, torch.float32, True)
    for rank, world, halo in ((0, 2, 1), (0, 4, 1 << 10), (1, 2, 1 << 10), (3, 4, 300)):
        local, owned, ok = sh.partition_slice(vf, rank, world, halo)
        start, C, L = sh._box_share(vf.n, rank, world, halo)
        assert owned == C and local.n == L
        for plane in local:
            assert plane.untyped_storage().nbytes() == plane.numel() * plane.element_size()
        real = max(0, min(vf.n - start, L))
        assert torch.equal(local.major_min[:real], vf.major_min[start:start + real])
        after = vf.major_min[start + L:]
        want = after.numel() == 0 or bool(after.min() > vf.major_max[start:start + C].max())
        assert bool(ok) == want
