"""The port's native host broad phase (``scalable_ccd_tpu_torch.host``)
against the JAX package's copy and the oracles.

The six cases of ``tests/test_host_native.py:54-149``: the boxes, one list,
two lists, 1 against 8 threads, the empty input and the batched sweep
against the unbatched one, with JAX ``host.sort_and_sweep`` and
``brute_force_overlaps`` as the reference.  The port's library is built
here with ``g++``; a build that fails fails the tests (nothing skips).

The JAX package's loader compiles straight to its fixed output path and
loads that path whenever the file exists, and it keeps a failed load for the
life of the process.  Test processes that start together (pytest-xdist
workers, each of which evaluates ``tests/test_host_native.py``'s skip
condition at collection) build that one file at once, and a worker can load
it half written.  Where the JAX library did not load in this process, the
module fixture builds the same source with the same flags into a file of
its own under ``build/host/`` (a temporary file, then renamed) and points the
JAX loader at it for this module.
"""

import hashlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu import host as jax_host
from scalable_ccd_tpu.broad_phase import (
    brute_force_overlaps,
    detect_overlaps,
    merge_two_lists,
    sort_boxes,
)
from scalable_ccd_tpu.geometry.aabb import build_edge_boxes, build_face_boxes, build_vertex_boxes
from scalable_ccd_tpu.geometry.scenes import cloth_on_sphere, triangle_soup
from scalable_ccd_tpu_torch import host


REPO = Path(__file__).resolve().parent.parent

#: the JAX package's compiler flags (``scalable_ccd_tpu/host/__init__.py:_compile``)
_JAX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _build_jax_library() -> Path:
    """The JAX package's ``_native/sweep.cpp`` built with its flags into a
    file of this test's own under ``build/host/``: a temporary file beside
    it, then renamed, so no process loads it half written."""
    src = Path(jax_host._SRC)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_JAX_FLAGS).encode()).hexdigest()[:16]
    out = host.BUILD_DIR / f"libsccd_host_jax-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_JAX_FLAGS, "-o", tmp, str(src), "-pthread"],
                              capture_output=True, text=True)
        assert proc.returncode == 0, f"g++ failed on {src.name}:\n{proc.stderr}"
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX package's host library loaded in this process: its own when
    it loads, else a private build (module docstring)."""
    mp = pytest.MonkeyPatch()
    if not jax_host.native_available():
        mp.setattr(jax_host, "_LIB_PATH", str(_build_jax_library()))
        mp.setattr(jax_host, "_lib", None)
        mp.setattr(jax_host, "_load_error", None)
        assert jax_host.native_available(), f"the JAX host library: {jax_host._load_error}"
    yield
    mp.undo()


@pytest.fixture(scope="module")
def scene():
    assert host.native_available(), f"the port's host library did not build: {host._load_error}"
    return cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.6)


def _vertex_ids(n):
    ids = np.arange(n, dtype=np.int32)
    return np.stack([ids, -ids - 1, -ids - 1], axis=1)


def _edge_vertex_ids(e):
    return np.stack([e[:, 0], e[:, 1], -e[:, 0] - 1], axis=1).astype(np.int32)


def _boxes(mod, scene):
    vmin, vmax = mod.build_vertex_boxes(scene.vertices_t0, scene.vertices_t1)
    return ((vmin, vmax), mod.build_element_boxes(vmin, vmax, scene.edges),
            mod.build_element_boxes(vmin, vmax, scene.faces))


def _set(pairs):
    return set(map(tuple, np.asarray(pairs).tolist()))


def test_boxes_match_jax_host_and_jax(scene):
    """Bitwise the JAX package's native boxes, also from CPU tensors, and
    JAX's boxes up to the denormals XLA:CPU flushes (``:54-69``)."""
    port = _boxes(host, scene)
    for got, want in zip(port, _boxes(jax_host, scene)):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)
    t = host.build_vertex_boxes(torch.as_tensor(scene.vertices_t0),
                                torch.as_tensor(scene.vertices_t1))
    assert all(np.array_equal(a, b) for a, b in zip(t, port[0]))
    vb = build_vertex_boxes(scene.vertices_t0, scene.vertices_t1, dtype=jnp.float64)
    for (lo, hi), jb in zip(port, (vb, build_edge_boxes(vb, scene.edges),
                                   build_face_boxes(vb, scene.faces))):
        np.testing.assert_allclose(lo, np.asarray(jb.min), rtol=0, atol=1e-300)
        np.testing.assert_allclose(hi, np.asarray(jb.max), rtol=0, atol=1e-300)


def test_ee_one_list_matches_oracles(scene):
    _, (emin, emax), _ = _boxes(host, scene)
    e = scene.edges
    args = (emin, emax, _edge_vertex_ids(e), np.arange(len(e), dtype=np.int32))
    pairs, next_axis = host.sort_and_sweep(*args)
    want, want_axis = jax_host.sort_and_sweep(*args)
    vb = build_vertex_boxes(scene.vertices_t0, scene.vertices_t1, dtype=jnp.float64)
    brute = brute_force_overlaps(build_edge_boxes(vb, e))
    assert _set(pairs) == _set(want) == _set(brute) and len(pairs) > 0
    assert next_axis == want_axis and next_axis in (0, 1, 2)


def test_vf_two_list_matches_oracles(scene):
    (vmin, vmax), _, (fmin, fmax) = _boxes(host, scene)
    nv, nf = len(vmin), len(fmin)
    args = (np.concatenate([vmin, fmin]), np.concatenate([vmax, fmax]),
            np.concatenate([_vertex_ids(nv), np.asarray(scene.faces, np.int32)]),
            np.concatenate([-np.arange(nv, dtype=np.int32) - 1, np.arange(nf, dtype=np.int32)]))
    pairs, _ = host.sort_and_sweep(*args, two_lists=True)
    tensors, _ = host.sort_and_sweep(*(torch.as_tensor(a) for a in args), two_lists=True)
    want, _ = jax_host.sort_and_sweep(*args, two_lists=True)
    vb = build_vertex_boxes(scene.vertices_t0, scene.vertices_t1, dtype=jnp.float64)
    fb = build_face_boxes(vb, scene.faces)
    sweep = detect_overlaps(sort_boxes(merge_two_lists(vb, fb)), is_two_lists=True)
    assert _set(pairs) == _set(tensors) == _set(want) == _set(sweep)
    assert _set(pairs) == _set(brute_force_overlaps(vb, fb)) and len(pairs) > 0


def test_threading_invariance(scene):
    _, (emin, emax), _ = _boxes(host, scene)
    e = scene.edges
    args = (emin, emax, _edge_vertex_ids(e), np.arange(len(e), dtype=np.int32))
    p1, _ = host.sort_and_sweep(*args, n_threads=1)
    p8, _ = host.sort_and_sweep(*args, n_threads=8)
    assert _set(p1) == _set(p8) == _set(jax_host.sort_and_sweep(*args, n_threads=8)[0])


def test_empty(scene):
    pairs, _ = host.sort_and_sweep(np.zeros((0, 3)), np.zeros((0, 3)),
                                   np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
    assert pairs.shape == (0, 2) and pairs.dtype == np.int32


def test_batched_sweep_matches_unbatched(scene, monkeypatch):
    """``SCCD_HOST_BATCH`` forces the adaptive box batching; the pair set
    and the next axis stay those of one batch, and the JAX package's."""
    s = triangle_soup(150, motion=0.2, seed=7)
    vmin, vmax = host.build_vertex_boxes(s.vertices_t0, s.vertices_t1)
    f = np.asarray(s.faces, np.int32)
    emin, emax = host.build_element_boxes(vmin, vmax, f)
    args = (emin, emax, f.copy(), np.arange(len(f), dtype=np.int32))
    full, ax_full = host.sort_and_sweep(*args)
    monkeypatch.setenv("SCCD_HOST_BATCH", "7")
    batched, ax_b = host.sort_and_sweep(*args)
    want, ax_want = jax_host.sort_and_sweep(*args)
    assert ax_b == ax_full == ax_want
    assert _set(full) == _set(batched) == _set(want) and len(full) > 0


def test_builds_into_the_build_directory(scene):
    """The library lives under the ignored ``build/host/``, not beside the
    source, and a CUDA tensor is refused."""
    path = host._library_path()
    assert path.exists() and path.parent == host.BUILD_DIR
    assert not (host._SRC.parent / "libsccd_host.so").exists()
    with pytest.raises(ValueError, match="CPU tensors"):
        host._array(torch.zeros(3, device="meta"), np.float64)


_TWO_BUILDS = """
import sys, time
from pathlib import Path
from scalable_ccd_tpu_torch import host
build, me, other = Path(sys.argv[1]), sys.argv[2], sys.argv[3]
host.BUILD_DIR = build
(build.parent / me).touch()
deadline = time.monotonic() + 120
while not (build.parent / other).exists() and time.monotonic() < deadline:
    time.sleep(0.01)
ok = host.native_available()
print(ok, host._load_error)
sys.exit(0 if ok else 1)
"""


def test_port_library_builds_from_two_processes_at_once(tmp_path):
    """Two processes that find no library build it into the same path at
    once (each waits for the other to be ready first); both load it, since
    each writes a temporary file and renames it, and nothing is left beside
    the library."""
    build = tmp_path / "host"
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_BUILDS, str(build), me, other],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for me, other in (("a", "b"), ("b", "a"))]
    t0 = time.monotonic()
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert time.monotonic() - t0 < 300
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [p.name for p in build.iterdir()] == [host._library_path().name]
