"""The benchmark's plain reference: what one call of the program has to
return for one frame, from the frame's own inputs alone.

It imports nothing of the program.  :func:`reference_frame` builds the
frame's boxes (:mod:`ccd_bench.reference.boxes`), finds every candidate pair
(:mod:`ccd_bench.reference.broad`) and solves them
(:mod:`ccd_bench.reference.narrow`), VF before EE, in blocks of
:data:`ROW_BLOCK` candidates, one running TOI.
"""

from __future__ import annotations

import numpy as np
import torch

from ccd_bench.reference import boxes, broad, narrow

__all__ = ["reference_frame", "PRECISIONS"]

#: candidates packed and solved at once: a block's rows and their first
#: evaluation take a few GiB
ROW_BLOCK = 1 << 24
#: the precisions the reference runs in: the configuration's, and the
#: control's storage one step below it
PRECISIONS = ("float32", "bfloat16")


def reference_frame(v0: np.ndarray, v1: np.ndarray, edges: np.ndarray, faces: np.ndarray,
                    tolerance: float, device, precision: str = "float32",
                    tile: int = 1 << 16) -> dict:
    """``{"vf_total", "ee_total", "overflowed", "toi", "solver_capped"}``
    of one frame (float64 ``(n, 3)`` positions, int edges and faces).
    ``precision="bfloat16"`` stores the boxes and positions in bfloat16,
    rounded outward and to nearest, and computes in float32."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    bf16 = precision == "bfloat16"
    t0 = torch.as_tensor(v0, dtype=torch.float64, device=device)
    t1 = torch.as_tensor(v1, dtype=torch.float64, device=device)
    e = torch.as_tensor(np.asarray(edges), dtype=torch.int64, device=device)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=device)
    vb = boxes.vertex_boxes(t0, t1, torch.bfloat16 if bf16 else torch.float32)
    vf = broad.vf_pairs(vb, boxes.face_boxes(vb, f), f)
    ee = broad.ee_pairs(boxes.edge_boxes(vb, e), e)
    vcat = torch.cat([t0, t1], dim=1).float()
    if bf16:
        vcat = vcat.to(torch.bfloat16).float()
    toi = torch.ones((), dtype=torch.float32, device=device)
    capped = False
    for pairs, is_vf in ((vf, True), (ee, False)):
        if pairs.shape[0] == 0:
            continue
        # in blocks of rows, one running TOI, so that any count fits
        for block in torch.split(pairs, ROW_BLOCK):
            rows = narrow.pack_rows(vcat, block, is_vf, f, e, tolerance)
            toi, ovf = narrow.solve(rows, is_vf, toi, tolerance, tile)
            capped = capped or bool(ovf)
            del rows
    return {"vf_total": int(vf.shape[0]), "ee_total": int(ee.shape[0]), "overflowed": False,
            "toi": float(toi), "solver_capped": capped}
