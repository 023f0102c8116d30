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

On the card the kernel is held to this plain version bitwise
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_ccd_tpu.narrow_phase import types as jtypes
from scalable_ccd_tpu.ops.pallas_solver import pack_query_rows as jpack
from scalable_ccd_tpu_torch.narrow_phase import types
from scalable_ccd_tpu_torch.ops import gather_pack as gp
from scalable_ccd_tpu_torch.pipeline.fused import NarrowSolver

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


def test_wrapper_on_cpu_is_the_plain_version(mesh, monkeypatch):
    """CPU tensors take the plain version and launch nothing, also through
    ``NarrowSolver.rows`` (the narrow loop's one call site); other devices
    raise."""
    monkeypatch.setattr(gp, "LAUNCHES", 0)
    v0, v1, faces, edges, vf, _ = mesh
    pairs, vcat, table = _port(mesh, True, torch.float32)
    nar = NarrowSolver.for_phase(True, torch.from_numpy(v0), torch.from_numpy(v1),
                                 torch.from_numpy(edges), torch.from_numpy(faces), 1e-3, TOL,
                                 True, -1)
    got = nar.rows(pairs)
    want = gp.gather_pack_reference(pairs, 0, N_PAIRS, vcat, table, True, 1e-3, TOL)
    assert torch.equal(got, want) and gp.LAUNCHES == 0
    assert torch.equal(nar.rows(pairs, exact=True)[30], torch.zeros(N_PAIRS))
    with pytest.raises(ValueError, match="unsupported device"):
        gp.gather_pack(pairs.to("meta"), 0, 4, vcat.to("meta"), table.to("meta"), True,
                       0.0, TOL)
