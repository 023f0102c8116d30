"""Kernel C's plain version (``ops/gather_pack.py``) against the JAX
package's gather and pack, on the CPU.

The inputs are made from a numpy seed: a random two-frame mesh whose
coordinates straddle 1 (so the error filter's ``max(|x|, 1)`` takes both
sides), random faces and edges, and random candidate pairs with ids out of
range on both sides (the gather clamps them).  The port's columns-and-offset
plain version, on ``pairs[start:stop]``, must be bitwise the transpose of:

- f32: JAX ``pack_query_rows(gather_*_queries(...))``
  (``ops/pallas_solver.py:649``);
- f64, under x64: the JAX queue solver's rows of the same f64 queries
  (``narrow_phase/bfs.py:109-125``: the queries, ``compute_tolerance``,
  ``numerical_error_bound``, ms), since JAX ``pack_query_rows`` packs f32;
- compensated: the JAX queue solver's compensated rows of f32 queries,
  widened to f64 (the port solves them as f64).

The narrow loop packs a phase in chunks of whole batches (the streams of
``pipeline/fused.py``, with the chunk cap lowered here to a few batches so
that seams occur): every batch's column slice of its chunk must be bitwise
the per-batch plain columns, for pair rows and for kernel A' records.  The
records mode's plain twin (one search of the pair prefix, the decode, the
pack) must be bitwise the decode of the whole stream with the monotone
cursor followed by the pack, on runs that start and stop inside records, on
a record buffer cut at a budget and on an empty phase; and its rows and ids
must be, as a multiset of ``(pair, row)``, the JAX package's
``decode_records_range`` plus ``pack_query_rows`` of the same records.

On the card the kernel is held to this plain version bitwise
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_ccd_tpu.broad_phase import merge_two_lists as jmerge
from scalable_ccd_tpu.broad_phase import sort_boxes as jsort
from scalable_ccd_tpu.geometry import aabb as jaabb
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu.ops import pallas_sweep_ap as jap
from scalable_ccd_tpu.ops.pallas_solver import pack_query_rows as jpack
from scalable_ccd_tpu_torch.interop import from_numpy_boxes
from scalable_ccd_tpu_torch.narrow_phase import types
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.ops import sweep_records
from scalable_ccd_tpu_torch.pipeline.narrow import NarrowSolver, PairStream, RecordStream

torch.set_num_threads(2)

TOL = 1e-6
N_VERTS, N_FACES, N_EDGES, N_PAIRS = 50, 70, 90, 200


@pytest.fixture(scope="module")
def mesh():
    """``(v0, v1, faces, edges, vf pairs, ee pairs)`` as numpy arrays."""
    rng = np.random.default_rng(7)
    v0 = rng.uniform(-2.5, 2.5, (N_VERTS, 3))
    v1 = v0 + rng.normal(0.0, 0.4, (N_VERTS, 3))
    faces = rng.integers(0, N_VERTS, (N_FACES, 3)).astype(np.int32)
    edges = rng.integers(0, N_VERTS, (N_EDGES, 2)).astype(np.int32)

    def pairs(n_a, n_b):
        p = np.stack([rng.integers(-4, n_a + 4, N_PAIRS),
                      rng.integers(-4, n_b + 4, N_PAIRS)], axis=1).astype(np.int32)
        assert (p < 0).any() and (p[:, 0] >= n_a).any() and (p[:, 1] >= n_b).any()
        return p

    return v0, v1, faces, edges, pairs(N_VERTS, N_FACES), pairs(N_EDGES, N_EDGES)


def _port(mesh, is_vf, dt):
    """``(pairs, vcat, table)`` of the port in ``dt``."""
    v0, v1, faces, edges, vf, ee = mesh
    vcat = types.concat_frames(torch.from_numpy(v0), torch.from_numpy(v1), dt)
    if is_vf:
        return torch.from_numpy(vf), vcat, types.pack_face_table(vcat, torch.from_numpy(faces))
    return torch.from_numpy(ee), vcat, types.pack_edge_table(vcat, torch.from_numpy(edges))


def _jax_queries(mesh, is_vf, dt, start, stop):
    v0, v1, faces, edges, vf, ee = mesh
    j0, j1 = jnp.asarray(v0, dt), jnp.asarray(v1, dt)
    if is_vf:
        return jtypes.gather_vf_queries(j0, j1, faces, jnp.asarray(vf[start:stop]), dtype=dt)
    return jtypes.gather_ee_queries(j0, j1, edges, jnp.asarray(ee[start:stop]), dtype=dt)


def _jax_queue_rows(jq, is_vf, ms, compensated=False):
    """The JAX queue solver's packed rows (``bfs.py:109-125``)."""
    dt = jq.p0s.dtype
    ms_arr = jnp.broadcast_to(jnp.asarray(ms, dt), (jq.n,))
    err = jtypes.numerical_error_bound(jq, is_vf, ms > 0, compensated)
    tol = jtypes.compute_tolerance(jq, is_vf, jnp.asarray(TOL, dt))
    return np.concatenate([*map(np.asarray, jq), tol, err, ms_arr[:, None]], axis=1)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("start,stop", [(0, N_PAIRS), (37, 161)])
@pytest.mark.parametrize("ms", [0.0, 1e-3])
@pytest.mark.parametrize("is_vf", [True, False])
def test_plain_columns_equal_jax_pack_f32(mesh, is_vf, ms, start, stop):
    pairs, vcat, table = _port(mesh, is_vf, torch.float32)
    cols = gp.gather_pack(pairs, start, stop, vcat, table, is_vf, ms, TOL)
    assert cols.dtype == torch.float32 and cols.shape == (31, stop - start)
    assert cols.is_contiguous()
    want = np.asarray(jpack(_jax_queries(mesh, is_vf, jnp.float32, start, stop), is_vf, ms, TOL))
    assert np.array_equal(_bits(want.T), _bits(cols.numpy()))
    assert (cols[30] == np.float32(ms)).all()


@pytest.mark.parametrize("ms", [0.0, 1e-3])
@pytest.mark.parametrize("is_vf", [True, False])
def test_plain_columns_equal_jax_rows_f64(mesh, is_vf, ms):
    pairs, vcat, table = _port(mesh, is_vf, torch.float64)
    cols = gp.gather_pack(pairs, 11, N_PAIRS, vcat, table, is_vf, ms, TOL)
    assert cols.dtype == torch.float64
    want = _jax_queue_rows(_jax_queries(mesh, is_vf, jnp.float64, 11, N_PAIRS), is_vf, ms)
    assert want.dtype == np.float64
    assert np.array_equal(_bits(want.T), _bits(cols.numpy()))


@pytest.mark.parametrize("ms", [0.0, 1e-3])
@pytest.mark.parametrize("is_vf", [True, False])
def test_plain_compensated_columns_equal_jax_queue_rows(mesh, is_vf, ms):
    """f32 tables, the compensated error filter, written as f64: the JAX
    queue solver's compensated rows widened, bitwise; only the filter
    differs from the plain f32 rows."""
    pairs, vcat, table = _port(mesh, is_vf, torch.float32)
    cols = gp.gather_pack(pairs, 5, 150, vcat, table, is_vf, ms, TOL, compensated=True)
    assert cols.dtype == torch.float64 and gp.row_dtype(torch.float32, True) == torch.float64
    want = _jax_queue_rows(_jax_queries(mesh, is_vf, jnp.float32, 5, 150), is_vf, ms, True)
    assert want.dtype == np.float32
    assert np.array_equal(_bits(want.T.astype(np.float64)), _bits(cols.numpy()))
    plain = gp.gather_pack(pairs, 5, 150, vcat, table, is_vf, ms, TOL)
    assert torch.equal(cols[:27], plain[:27].double()) and torch.equal(cols[30], plain[30].double())
    assert (cols[27:30] < plain[27:30].double()).all()


@pytest.mark.parametrize("is_vf", [True, False])
def test_out_of_range_ids_are_clamped(mesh, is_vf):
    pairs, vcat, table = _port(mesh, is_vf, torch.float32)
    n_a = vcat.shape[0] if is_vf else table.shape[0]
    bad = torch.tensor([[-3, -1], [n_a + 7, table.shape[0] + 2], [0, 0]], dtype=torch.int32)
    good = torch.tensor([[0, 0], [n_a - 1, table.shape[0] - 1], [0, 0]], dtype=torch.int32)
    got = gp.gather_pack(bad, 0, 3, vcat, table, is_vf, 0.0, TOL)
    assert torch.equal(got, gp.gather_pack(good, 0, 3, vcat, table, is_vf, 0.0, TOL))
    assert gp.gather_pack(bad, 2, 2, vcat, table, is_vf, 0.0, TOL).shape == (31, 0)


def test_wrapper_on_cpu_is_the_plain_version(mesh):
    """CPU tensors take the plain version and launch nothing, also through
    ``NarrowSolver.pack`` (the narrow loop's call site); other devices
    raise."""
    before = gp.LAUNCHES_BY_MODE.total
    v0, v1, faces, edges, vf, _ = mesh
    pairs, vcat, table = _port(mesh, True, torch.float32)
    nar = NarrowSolver.for_phase(True, torch.from_numpy(v0), torch.from_numpy(v1),
                                 torch.from_numpy(edges), torch.from_numpy(faces), 1e-3, TOL,
                                 True, -1)
    got = nar.pack(pairs)
    want = gp.gather_pack_reference(pairs, 0, N_PAIRS, vcat, table, True, 1e-3, TOL)
    assert torch.equal(got, want) and gp.LAUNCHES_BY_MODE.total == before
    assert torch.equal(nar.pack(pairs, exact=True)[30], torch.zeros(N_PAIRS))
    with pytest.raises(ValueError, match="unsupported device"):
        gp.gather_pack(pairs.to("meta"), 0, 4, vcat.to("meta"), table.to("meta"), True,
                       0.0, TOL)


KINDS = {"f32": (torch.float32, False), "f64": (torch.float64, False),
         "compensated": (torch.float32, True)}


def _solver(mesh, is_vf, kind, ms=1e-3):
    v0, v1, faces, edges, _, _ = mesh
    dtype, comp = KINDS[kind]
    return NarrowSolver.for_phase(is_vf, torch.from_numpy(v0), torch.from_numpy(v1),
                                  torch.from_numpy(edges), torch.from_numpy(faces), ms, TOL,
                                  True, -1, -1, dtype, comp)


def _bitwise(a, b):
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints))


def test_chunk_rows_are_whole_batches_under_the_cap(monkeypatch):
    assert gp.CHUNK_ROWS == 1 << 20
    assert gp.chunk_rows(1 << 14) == 1 << 20 and gp.chunk_rows(1000) == 1048000
    assert gp.chunk_rows(3 << 20) == 3 << 20  # a batch past the cap is its own chunk
    monkeypatch.setattr(gp, "CHUNK_ROWS", 53)
    assert gp.chunk_rows(16) == 48 and gp.chunk_rows(60) == 60


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("is_vf", [True, False])
def test_chunked_pair_columns_equal_batch_columns(mesh, monkeypatch, is_vf, kind):
    """Batches of 16 out of chunks of three batches (the cap 53), taken in
    reverse order: each batch's column slice of its chunk is bitwise the
    plain columns of that batch alone, and the stream keeps one buffer of
    the chunk's width."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 53)
    nar = _solver(mesh, is_vf, kind)
    pairs = torch.from_numpy(mesh[4] if is_vf else mesh[5])
    stream = PairStream(pairs, N_PAIRS, nar, 16)
    assert stream.chunk == 48
    buffers = set()
    for start in reversed(range(0, N_PAIRS, 16)):
        stop = min(start + 16, N_PAIRS)
        cols = stream.cols(start, stop)
        want = gp.gather_pack_reference(pairs, start, stop, nar.vcat, nar.table, is_vf, 1e-3,
                                        TOL, KINDS[kind][1])
        assert cols.stride() == (48, 1) and _bitwise(cols, want), (start, stop)
        assert torch.equal(stream.ids(start, stop), pairs[start:stop])
        buffers.add(cols.untyped_storage().data_ptr())
    assert len(buffers) == 1
    with pytest.raises(ValueError, match="one chunk"):
        stream.cols(40, 56)


def _record_phase(is_vf, rec_budget=0):
    """``(scene, JAX sorted boxes, sorted boxes, records, n_records,
    n_pairs, nar)`` of one phase of a small cloth scene, with kernel A''s
    plain version."""
    s = jscenes.cloth_on_sphere(grid_n=14, sphere_subdiv=1, drop=0.35)
    vb = jaabb.build_vertex_boxes(s.vertices_t0, s.vertices_t1, dtype=jnp.float32)
    m = (jmerge(vb, jaabb.build_face_boxes(vb, s.faces)) if is_vf
         else jaabb.build_edge_boxes(vb, s.edges))
    jsb = jsort(m)
    sb = from_numpy_boxes(jsb)
    rec, n_rec, n_pairs, _ = sweep_records.sweep_records(sb, is_vf, 1 << 15, rec_budget)
    nar = NarrowSolver.for_phase(is_vf, torch.from_numpy(s.vertices_t0),
                                 torch.from_numpy(s.vertices_t1), torch.from_numpy(s.edges),
                                 torch.from_numpy(s.faces), 1e-3, TOL, True, -1)
    return s, jsb, sb, rec, int(n_rec), int(n_pairs), nar


@pytest.mark.parametrize("is_vf", [True, False])
def test_chunked_record_columns_equal_decode_then_pack(monkeypatch, is_vf):
    """A records stream in batches of 7 out of chunks of three batches
    (seams inside records), taken in reverse order: each batch's columns
    and ids bitwise the decode of the whole stream (monotone cursor) packed
    per batch; ``all()`` gives the whole decode."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 23)
    _, _, sb, rec, n_rec, n_pairs, nar = _record_phase(is_vf)
    stream = RecordStream(sb, rec, n_rec, 1 << 15, is_vf, nar, 7, with_ids=True)
    assert stream.n == n_pairs > 3 * stream.chunk and stream.chunk == 21
    cum = stream.cum
    seams = range(stream.chunk, n_pairs, stream.chunk)
    assert any(not (cum == c).any() for c in seams), "no seam falls inside a record"
    whole = sweep_records.decode_records_range(sb, rec, cum, 0, n_pairs, 0, is_vf)[0]
    for start in reversed(range(0, n_pairs, 7)):
        stop = min(start + 7, n_pairs)
        want = gp.gather_pack_reference(whole, start, stop, nar.vcat, nar.table, is_vf, 1e-3,
                                        TOL)
        assert _bitwise(stream.cols(start, stop), want), (start, stop)
        assert torch.equal(stream.ids(start, stop), whole[start:stop])
    assert torch.equal(stream.all(), whole)


@pytest.mark.parametrize("is_vf", [True, False])
def test_record_twin_on_cut_runs_budget_and_empty_phase(is_vf):
    """The records mode's plain twin on runs that start and stop inside
    records, on a record buffer cut at a budget of 97 records with the pair
    count cut inside the last one, and on an empty stream: bitwise the
    cursor decode of the held pairs, then the pack."""
    _, _, sb, rec, n_rec, _, nar = _record_phase(is_vf, rec_budget=97)
    assert rec.shape[0] == 97 < n_rec
    held = sweep_records.records_pair_prefix(rec, 97)
    n = int(held[-1]) - 3
    whole = sweep_records.decode_records_range(sb, rec, held, 0, n, 0, is_vf)[0]
    stream = RecordStream(sb, rec, 97, n, is_vf, nar, 50, with_ids=True)
    assert stream.n == n
    for a, b in ((0, n), (1, n - 1), (5, 6), (n - 7, n), (17, 17)):
        ids = torch.zeros((b - a, 2), dtype=torch.int32)
        got = gp.gather_pack_records(sb, rec, held, a, b, nar.vcat, nar.table, is_vf, 1e-3,
                                     TOL, pairs_out=ids)
        want = gp.gather_pack_reference(whole, a, b, nar.vcat, nar.table, is_vf, 1e-3, TOL)
        assert _bitwise(got, want) and torch.equal(ids, whole[a:b]), (a, b)
    for start in range(0, n, 50):
        assert torch.equal(stream.ids(start, min(start + 50, n)), whole[start:start + 50])
    empty = torch.zeros((0, 8), dtype=torch.int32)
    none = RecordStream(sb, empty, 0, 1 << 15, is_vf, nar, 50)
    assert none.n == 0 and none.all().shape == (0, 2)
    cols = gp.gather_pack_records(sb, empty, sweep_records.records_pair_prefix(empty, 0), 0, 0,
                                  nar.vcat, nar.table, is_vf, 1e-3, TOL)
    assert cols.shape == (31, 0)


@pytest.mark.parametrize("is_vf", [True, False])
def test_record_rows_equal_jax_decode_and_pack(monkeypatch, is_vf):
    """Kernel C's records mode (plain version, in chunks of 120 pairs) on
    the records of a cloth scene against the JAX package's
    ``decode_records_range`` and ``pack_query_rows`` of the same records
    (in JAX's tiled buffer), as a multiset of ``(pair, row)``, bitwise."""
    monkeypatch.setattr(gp, "CHUNK_ROWS", 120)
    s, jsb, sb, rec, n_rec, n_pairs, nar = _record_phase(is_vf)
    nar = nar._replace(ms=0.0)
    stream = RecordStream(sb, rec, n_rec, 1 << 15, is_vf, nar, 40, with_ids=True)
    cuts = [(a, min(a + 40, n_pairs)) for a in range(0, n_pairs, 40)]
    cols = torch.cat([stream.cols(a, b).clone() for a, b in cuts], 1)
    ids = torch.cat([stream.ids(a, b).clone() for a, b in cuts])
    # JAX's buffer: 16 records of 8 words per 128-word row
    tiled = np.zeros((-(-rec.shape[0] // 16) * 16, 8), np.int32)
    tiled[:rec.shape[0]] = rec.numpy()
    jrec = jnp.asarray(tiled.reshape(-1, 128))
    jcum = jap.records_pair_prefix(jrec, jnp.int32(n_rec))
    packed, _ = jap.pack_boxes_ap(jsb)
    jpairs, _ = jap.decode_records_range(packed, jrec, jcum, jnp.int32(0), n_pairs,
                                         jnp.int32(n_pairs), jnp.int32(0), is_vf)
    jpairs = np.asarray(jpairs)[:n_pairs]
    j0 = jnp.asarray(s.vertices_t0, jnp.float32)
    j1 = jnp.asarray(s.vertices_t1, jnp.float32)
    jq = (jtypes.gather_vf_queries(j0, j1, s.faces, jnp.asarray(jpairs), dtype=jnp.float32)
          if is_vf else
          jtypes.gather_ee_queries(j0, j1, s.edges, jnp.asarray(jpairs), dtype=jnp.float32))
    jrows = np.asarray(jpack(jq, is_vf, 0.0, TOL))

    def keyed(pairs, rows):
        p = np.asarray(pairs, np.int64)
        order = np.argsort(p[:, 0] * (1 << 32) + p[:, 1], kind="stable")
        return p[order], _bits(np.ascontiguousarray(rows)[order])

    kp, kr = keyed(ids.numpy(), cols.t().numpy())
    jp_, jr = keyed(jpairs, jrows)
    assert len(np.unique(kp, axis=0)) == n_pairs
    assert np.array_equal(kp, jp_) and np.array_equal(kr, jr)
