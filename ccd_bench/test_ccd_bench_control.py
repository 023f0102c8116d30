"""The comparison that decides ``correct`` has to fail what is wrong.

    python -m pytest ccd_bench/test_ccd_bench_control.py -q

- The control, the reference one precision below the configuration's
  (boxes and positions stored in bfloat16), put in the program's place,
  is found wrong; on the card it runs at the cells' own sizes
  (``ccd_bench/control.py``), here on the configurations cut to a small
  cloth.
- A run on the CPU (``--device cpu``, which skips the look for a card),
  with the program's entry point broken underneath, comes out not correct
  for each fault a call can have: a call that returns the state it started
  from; half of the candidates left out; an answer altered where it is
  produced (the TOI one float32 step earlier, a count one higher, the
  solver's cap flag flipped); pair budgets too small to hold the pairs,
  which drop candidates and raise the overflow flag.  The cells run on one
  card, so no exchange between cards can be left out.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import scalable_ccd_tpu_torch
from ccd_bench import check, control, harness
from ccd_bench.test_ccd_bench_harness import _tiny_tree

REAL = scalable_ccd_tpu_torch.fused_ccd
WORKLOADS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_found_wrong(tmp_path, workload):
    bench = _tiny_tree(tmp_path, grid=24)
    out = control.control(workload, 2**31 + 77, "cpu", bench, tmp_path)
    assert out["correct"] is False
    over = {n for n, e in out["check"].items() if e["value"] > e["limit"]}
    assert over & {"vf_total_gap", "ee_total_gap", "toi_gap"}


def _state_unchanged(v0, v1, edges, faces, device=None, **kw):
    """A call that returns what it started from: no candidates, TOI 1."""
    z = torch.zeros((), dtype=torch.int64)
    return scalable_ccd_tpu_torch.FusedCCDResult(
        toi=torch.ones(()), overflowed=torch.zeros((), dtype=torch.bool), vf_total=z,
        ee_total=z, total_checks=z, solver_capped=torch.zeros((), dtype=torch.bool),
        ipc_refinements=z)


def _half_left_out(v0, v1, edges, faces, **kw):
    """A call over half of the candidates: those of every other face and
    edge."""
    return REAL(v0, v1, np.asarray(edges)[::2], np.asarray(faces)[::2], **kw)


def _toi_one_step_early(*args, **kw):
    res = REAL(*args, **kw)
    return res._replace(toi=torch.nextafter(res.toi, torch.zeros_like(res.toi)))


def _count_altered(*args, **kw):
    res = REAL(*args, **kw)
    return res._replace(ee_total=res.ee_total + 1)


def _budget_too_small(*args, **kw):
    """Pair budgets that cannot hold a phase's pairs: candidates dropped,
    and the overflow flag raised."""
    return REAL(*args, vf_budget=16, ee_budget=16, **kw)


def _capped_flipped(*args, **kw):
    res = REAL(*args, **kw)
    return res._replace(solver_capped=~res.solver_capped)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _toi_one_step_early,
                                   _count_altered, _budget_too_small, _capped_flipped],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_broken_program_is_not_correct(tmp_path, capsys, monkeypatch, workload, fault):
    bench = _tiny_tree(tmp_path, grid=14)
    argv = ["--workload", workload, "--seed", str(2**33 + 1), "--seconds", "0.2",
            "--device", "cpu", "--benchmark", str(bench), "--base", str(tmp_path)]
    assert harness.main(argv) == 0
    sound = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sound["correct"] is True
    monkeypatch.setattr(scalable_ccd_tpu_torch, "fused_ccd", fault)
    assert harness.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and line["failed"] > 0
    assert any(e["value"] > check.LIMITS[n] for n, e in line["check"].items())
