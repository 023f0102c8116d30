"""PyTorch port's ``fused_ccd`` vs the JAX package's ``fused_ccd``, on the CPU.

On the CPU the JAX main path runs its XLA sweep and queue solver, and the
port runs the plain versions of its two kernels: the TOI must agree within
``abs=1e-7`` and the pair totals exactly.  Also: the golden-scene bar of
``tests/test_golden_data.py``, the auto-budget retry, and the port's
guarantees (no jax import, no kernel launch and no silent CPU run).
"""

import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scalable_ccd_tpu.geometry import mesh as jmesh
from scalable_ccd_tpu.geometry import scenes as jscenes
from scalable_ccd_tpu.pipeline.fused import fused_ccd as jax_fused_ccd
import scalable_ccd_tpu_torch
from scalable_ccd_tpu_torch import fused_ccd
from scalable_ccd_tpu_torch.interop import from_numpy_scene, fused_kwargs_from_jax
from scalable_ccd_tpu_torch.ops import solver, sweep_ap
from scalable_ccd_tpu_torch.pipeline import fused as port_fused

torch.set_num_threads(2)

CPU = dict(device="cpu")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

SCENES = {
    "cloth12": lambda: jscenes.cloth_on_sphere(grid_n=12, sphere_subdiv=1, drop=0.35),
    "cloth20": lambda: jscenes.cloth_on_sphere(grid_n=20, sphere_subdiv=2, drop=0.3, seed=1),
    "soup": lambda: jscenes.triangle_soup(80, motion=0.25, seed=4),
}


def _args(s):
    return s.vertices_t0, s.vertices_t1, s.edges, s.faces


def _assert_same(res, ref):
    assert not bool(res.overflowed) and not bool(ref.overflowed)
    assert float(res.toi) == pytest.approx(float(ref.toi), abs=1e-7)
    assert int(res.vf_total) == int(ref.vf_total)
    assert int(res.ee_total) == int(ref.ee_total)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fused_matches_jax(name):
    s = SCENES[name]()
    ref = jax_fused_ccd(*_args(s), dtype=jnp.float32)
    res = fused_ccd(*_args(s), **CPU)
    _assert_same(res, ref)
    assert 0.0 <= float(res.toi) <= 1.0 and int(res.total_checks) > 0


@pytest.mark.parametrize("presample", [True, False])
def test_fused_presample_and_narrow_batch_match_jax(presample):
    """Batches of 4,096 (the budget holds four, so a presample runs when
    asked) with the warm-start batch on and off: TOI and totals of JAX
    ``fused_ccd`` with the same options, also through ``interop``."""
    s = SCENES["cloth20"]()
    jkw = dict(presample=presample, narrow_batch=1 << 12)
    ref = jax_fused_ccd(*_args(s), dtype=jnp.float32, **jkw)
    kw = fused_kwargs_from_jax(**jkw)
    assert kw == jkw
    res = fused_ccd(*_args(s), **kw, **CPU)
    _assert_same(res, ref)
    # per phase
    mixed = fused_ccd(*_args(s), presample=(presample, not presample), narrow_batch=1 << 12,
                      **CPU)
    _assert_same(mixed, ref)


def test_fused_defaults_are_auto_presample_and_batches_of_16384(monkeypatch):
    """The defaults resolve as before the options existed: a presample in
    each phase below 2^20 boxes and batches of 16,384."""
    s = SCENES["cloth20"]()
    calls = []
    real = port_fused._narrow_phase
    monkeypatch.setattr(port_fused, "_narrow_phase",
                        lambda stream, budget, presample, *a: calls.append(
                            (budget, stream.batch, presample))
                        or real(stream, budget, presample, *a))
    res = fused_ccd(*_args(s), **CPU)
    assert len(calls) == 2
    assert all(batch == min(budget, 1 << 14) and ps for budget, batch, ps in calls)
    explicit = fused_ccd(*_args(s), presample=True, narrow_batch=1 << 14, **CPU)
    for a, b in zip(res, explicit):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="narrow_batch"):
        fused_ccd(*_args(s), narrow_batch=0, **CPU)
    with pytest.raises(ValueError, match="presample"):
        fused_ccd(*_args(s), presample=(True,), **CPU)


def test_fused_tensor_inputs_match_numpy_inputs():
    s = SCENES["cloth12"]()
    res = fused_ccd(*from_numpy_scene(s), **CPU)
    ref = fused_ccd(*_args(s), **CPU)
    for a, b in zip(res, ref):
        assert torch.equal(a, b)
    assert res.toi.device.type == "cpu"


@pytest.mark.parametrize("name", ["cloth-sphere-16", "dense-cluster", "soup-60"])
def test_fused_golden_toi(name):
    """The rule of ``test_golden_data.py:293-301``: never later than the f64
    oracle, and close to it where plain f32 suffices."""
    base = os.path.join(GOLDEN, name)
    with open(os.path.join(base, "toi.json")) as fh:
        golden = json.load(fh)
    assert golden["min_distance"] == 0.0
    v0, f = jmesh.read_ply(os.path.join(base, "frames", "f0.ply"))
    v1, _ = jmesh.read_ply(os.path.join(base, "frames", "f1.ply"))
    res = fused_ccd(
        v0, v1, jmesh.edges_from_faces(f), f, tolerance=golden["tolerance"],
        allow_zero_toi=golden["allow_zero_toi"], **CPU,
    )
    assert not bool(res.overflowed)
    assert float(res.toi) <= golden["toi"] * (1 + 1e-4) + 1e-7
    if name in ("cloth-sphere-16", "soup-60"):
        assert float(res.toi) == pytest.approx(golden["toi"], rel=2e-2, abs=1e-6)


def test_auto_budget_retry_from_exact_totals(monkeypatch):
    """Undersized guesses overflow both phases; each retries once at its
    exact total, ends equal to JAX, and the grown budgets are remembered."""
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MIN", 1)
    monkeypatch.setattr(port_fused, "_AUTO_VF_GUESS", 0)
    monkeypatch.setattr(port_fused, "_AUTO_EE_GUESS", 0)
    monkeypatch.setattr(port_fused, "_AUTO_BUDGET_MEMO", {})
    calls = []
    real = port_fused.sweep_pairs
    monkeypatch.setattr(
        port_fused, "sweep_pairs",
        lambda sb, two, budget, **kw: calls.append(budget) or real(sb, two, budget, **kw),
    )
    s = SCENES["cloth12"]()
    res = fused_ccd(*_args(s), **CPU)
    ref = jax_fused_ccd(*_args(s), dtype=jnp.float32)
    _assert_same(res, ref)
    vf, ee = int(ref.vf_total), int(ref.ee_total)
    pow2 = lambda n: 1 << (n - 1).bit_length()  # noqa: E731
    assert calls == [1, pow2(vf), 1, pow2(ee)]
    assert port_fused._AUTO_BUDGET_MEMO == {(1, 1, "pairs"): (pow2(vf), pow2(ee))}
    # the next frame of the same size class starts at the grown budgets
    calls.clear()
    _assert_same(fused_ccd(*_args(s), **CPU), ref)
    assert calls == [pow2(vf), pow2(ee)]


def test_explicit_budget_overflow_is_reported():
    s = SCENES["soup"]()
    ref = jax_fused_ccd(*_args(s), dtype=jnp.float32)
    res = fused_ccd(*_args(s), vf_budget=8, ee_budget=1 << 16, **CPU)
    assert bool(res.overflowed)
    assert int(res.vf_total) == int(ref.vf_total) > 8
    assert int(res.ee_total) == int(ref.ee_total)


def test_port_never_imports_jax():
    root = pathlib.Path(scalable_ccd_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) >= 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "scalable_ccd_tpu"), (path, n)


def test_cpu_calls_launch_no_kernel():
    before = (sweep_ap.LAUNCHES_BY_MODE.total, solver.LAUNCHES_BY_MODE.total)
    fused_ccd(*_args(SCENES["cloth12"]()), **CPU)
    assert (sweep_ap.LAUNCHES_BY_MODE.total, solver.LAUNCHES_BY_MODE.total) == before


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_ccd(*_args(SCENES["cloth12"]()), device="cuda")


def test_entry_points_default_to_cuda():
    """With no ``device`` the entry points run on CUDA whatever the inputs
    are (numpy arrays or CPU tensors); without CUDA they raise, naming it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    s = SCENES["cloth12"]()
    for args in (_args(s), tuple(from_numpy_scene(s))):
        with pytest.raises(RuntimeError, match="CUDA"):
            fused_ccd(*args)
        with pytest.raises(RuntimeError, match="CUDA"):
            scalable_ccd_tpu_torch.ccd(*args)
        with pytest.raises(RuntimeError, match="CUDA"):
            scalable_ccd_tpu_torch.ipc_ccd_strategy(*args, min_distance=1e-3)
