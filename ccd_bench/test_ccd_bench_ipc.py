"""The comparison that decides ``correct`` in the cell ``clothball_ipc.ipc_sim``
has to fail what is wrong.

    python -m pytest ccd_bench/test_ccd_bench_ipc.py -q

The faults of ``test_ccd_bench_control.py`` are planted in ``fused_ccd``,
which this cell does not call; here the same faults are planted in the
program's ``ipc_ccd_strategy``, and a run on the CPU (``--device cpu``) on
the configuration cut to a small cloth comes out not correct for each: a
call that returns the state it started from; half of the candidates left
out; an answer altered where it is produced (the TOI one float32 step
earlier, a count one higher, the solver's cap flag flipped).  The chunked
path has no pair budget to make too small: a chunk past its buffer is
swept again.  The separation, the IPC rule and the chunking are held in
``tests/test_torch_ipc_reference.py``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import scalable_ccd_tpu_torch
from ccd_bench import check, harness
from ccd_bench.test_ccd_bench_harness import _tiny_tree

REAL = scalable_ccd_tpu_torch.ipc_ccd_strategy
WORKLOAD = "clothball_ipc.ipc_sim"


def _state_unchanged(v0, v1, edges, faces, **kw):
    """A call that returns what it started from: no candidates, TOI 1."""
    return 1.0


def _half_left_out(v0, v1, edges, faces, **kw):
    """A call over half of the candidates: those of every other face and
    edge."""
    return REAL(v0, v1, np.asarray(edges)[::2], np.asarray(faces)[::2], **kw)


def _toi_one_step_early(*args, **kw):
    toi = torch.tensor(REAL(*args, **kw), dtype=torch.float32)
    return float(torch.nextafter(toi, torch.zeros_like(toi)))


def _count_altered(*args, stats, **kw):
    toi = REAL(*args, stats=stats, **kw)
    stats.ee_candidates += 1
    return toi


def _capped_flipped(*args, stats, **kw):
    toi = REAL(*args, stats=stats, **kw)
    stats.overflow_queries = 0 if stats.overflow_queries else 1
    return toi


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _toi_one_step_early,
                                   _count_altered, _capped_flipped],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_ipc_ccd_strategy_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    bench = _tiny_tree(tmp_path, grid=14)
    argv = ["--workload", WORKLOAD, "--seed", str(2**33 + 1), "--seconds", "0.2",
            "--device", "cpu", "--benchmark", str(bench), "--base", str(tmp_path)]
    assert harness.main(argv) == 0
    sound = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sound["correct"] is True
    monkeypatch.setattr(scalable_ccd_tpu_torch, "ipc_ccd_strategy", fault)
    assert harness.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False and line["failed"] > 0
    assert any(e["value"] > check.LIMITS[n] for n, e in line["check"].items())
