"""Reference ``ipc_ccd_strategy``: what the program's ``ipc_ccd_strategy(v0,
v1, edges, faces, min_distance=ms, max_iterations=cap, tolerance=tol)`` has
to return for one frame, from the published semantics of Scalable-CCD's
``cuda::ipc_ccd_strategy`` (``ipc_ccd_strategy.cu:43-93``) and of its
tight-inclusion solver; it imports nothing of the program.

- Boxes: the vertex boxes of :mod:`ccd_bench.reference.boxes` (the min and
  max over t=0 and t=1, cast to float32, one ulp outward by ``nextafter``,
  subnormals flushed), widened further by the separation rounded up,
  ``nextafter(float32(ms), inf)``, as ``AABB::conservative_inflation``
  does; edge and face boxes are unions of them.
- Candidates: every overlapping vertex-face and edge-edge pair sharing no
  vertex (:mod:`ccd_bench.reference.broad`), counted exactly.
- Broad chunks: the reference sorts each phase's boxes by their lower x
  bound, stably (VF: the vertices, then the faces), and a pair belongs to
  the chunk of ``box_chunk_size`` sorted boxes that holds the earlier of
  its two boxes in that order: the chunk cursor of ``broad_phase.cu:121-224``,
  with the configuration's fixed chunk size where the published memory
  handler sizes chunks from the card's free memory.
  Chunks run VF then EE, each in order, with one running TOI; the EE phase
  runs only while the TOI is above 0, and a phase stops at a chunk that
  leaves it at 0.
- Per chunk (:mod:`ccd_bench.reference.ipc_narrow`): the candidates are
  solved from the running TOI with the separation in their rows, the cap
  on each query's checks and zero TOIs allowed.  Where that leaves the TOI
  below 1e-6, the result is discarded, the chunk is solved again from the
  TOI before it with no separation, no cap and no zero TOI, and the TOI
  is backed off by 0.8.
- The running TOI is held as the port's API holds it: a float64 on the
  host, seeding each solve rounded to float32, the solve's float32 result
  read back exactly, the back-off a float64 product (the published code
  keeps the TOI in its build's one scalar type).
- ``solver_capped``: a conservative accept fired in any solve, the
  discarded ones included.

Departures from the program's own loop, none of which changes the TOI or
the counts: a chunk's candidates are solved in blocks of at most
:data:`ROW_BLOCK` rows rather than in the program's batches, with no
warm-start batch, and a solve does not stop at the first batch that
leaves the TOI at 0, so ``solver_capped`` also counts conservative accepts
in batches that the program would skip after such a batch.  Where the cap
on a query's checks binds, the answer depends on the search's order (see
:mod:`ccd_bench.reference.ipc_narrow`).

``control`` is the same reference one precision below the configuration's:
boxes rounded outward and positions rounded to bfloat16, computed in
float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ccd_bench.reference import boxes, broad, ipc_narrow

__all__ = ["OPTIONS", "CONTROL", "validate", "frame", "ipc_frame"]

#: keywords of the entry point this reference models
OPTIONS = ("min_distance", "max_iterations", "tolerance")
#: the configuration's precision, and the control's one step below it
CONTROL = {"float32": "bfloat16"}
#: the IPC rule refines a chunk whose TOI falls below this, and backs off
IPC_MIN_TOI = 1e-6
IPC_BACKOFF = 0.8
#: candidates packed and solved at once
ROW_BLOCK = 1 << 24


def validate(config: dict, options: dict) -> None:
    """Raises ``ValueError`` where the cell asks for what this reference
    does not model."""
    unmodelled = sorted(set(options) - set(OPTIONS))
    if unmodelled:
        raise ValueError(f"the reference does not model the options {unmodelled}")
    if config["precision"] not in CONTROL:
        raise ValueError(f"the reference does not model the precision {config['precision']!r}")
    if "box_chunk_size" not in config.get("assumed", {}):
        raise ValueError("the configuration states no box_chunk_size under assumed")


def _inflated_vertex_boxes(t0, t1, ms: float, bf16: bool) -> boxes.Boxes:
    """The vertex boxes of :func:`ccd_bench.reference.boxes.vertex_boxes`
    widened by ``ms`` rounded up (float32, subnormals flushed)."""
    vb = boxes.vertex_boxes(t0, t1)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=t0.device)
    r = boxes._flush(torch.nextafter(torch.full((), ms, dtype=torch.float32,
                                                device=t0.device), inf))
    lo, hi = boxes._flush(vb.lo - r), boxes._flush(vb.hi + r)
    return boxes.round_out_bf16(lo, hi) if bf16 else boxes.Boxes(lo, hi)


def _sorted_rank(lo_x: torch.Tensor) -> torch.Tensor:
    """Each box's place in the stable sort of ``lo_x`` (-0 and +0 alike)."""
    order = torch.argsort(broad._x_key(lo_x), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def ipc_frame(v0: np.ndarray, v1: np.ndarray, edges: np.ndarray, faces: np.ndarray, ms: float,
              max_iterations: int, tolerance: float, box_chunk_size: int, device,
              precision: str = "float32", tile: int = 1 << 16) -> dict:
    """``{"vf_total", "ee_total", "overflowed", "toi", "solver_capped",
    "ipc_refinements"}`` of one frame (float64 ``(n, 3)`` positions, int
    edges and faces)."""
    if precision not in ("float32", "bfloat16"):
        raise ValueError(f"precision {precision!r}: float32 or bfloat16")
    # float32 products stay float32 on the card (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16 = precision == "bfloat16"
    t0 = torch.as_tensor(v0, dtype=torch.float64, device=device)
    t1 = torch.as_tensor(v1, dtype=torch.float64, device=device)
    e = torch.as_tensor(np.asarray(edges), dtype=torch.int64, device=device)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=device)
    vb = _inflated_vertex_boxes(t0, t1, ms, bf16)
    fb, eb = boxes.face_boxes(vb, f), boxes.edge_boxes(vb, e)
    vf = broad.vf_pairs(vb, fb, f)
    ee = broad.ee_pairs(eb, e)
    nv = vb.lo.shape[0]
    rank = _sorted_rank(torch.cat([vb.lo[:, 0], fb.lo[:, 0]]))
    vf_chunk = torch.minimum(rank[vf[:, 0]], rank[nv + vf[:, 1]]) // box_chunk_size
    rank = _sorted_rank(eb.lo[:, 0])
    ee_chunk = torch.minimum(rank[ee[:, 0]], rank[ee[:, 1]]) // box_chunk_size
    vcat = torch.cat([t0, t1], dim=1).float()
    if bf16:
        vcat = vcat.to(torch.bfloat16).float()
    ms32 = float(torch.tensor(ms, dtype=torch.float32))
    capped = False

    def solve(pairs, is_vf, toi, exact):
        """The chunk's TOI from the running ``toi`` (a float), as a float."""
        nonlocal capped
        t = toi
        for block in torch.split(pairs, ROW_BLOCK):
            rows = ipc_narrow.pack_rows(vcat, block, is_vf, f, e, tolerance,
                                        0.0 if exact else ms32)
            t, ovf = ipc_narrow.solve(rows, is_vf, t, tolerance, tile,
                                      allow_zero_toi=not exact,
                                      max_iterations=-1 if exact else max_iterations)
            capped = capped or bool(ovf)
            t = float(t)
        return t

    toi, refinements = 1.0, 0
    for pairs, chunk_of, is_vf in ((vf, vf_chunk, True), (ee, ee_chunk, False)):
        if not toi > 0:
            break
        for c in torch.unique(chunk_of).tolist():
            mine = pairs[chunk_of == c]
            before = toi
            toi = solve(mine, is_vf, toi, exact=False)
            if toi < IPC_MIN_TOI:
                refinements += 1
                toi = solve(mine, is_vf, before, exact=True) * IPC_BACKOFF
            if toi <= 0:
                break
    return {"vf_total": int(vf.shape[0]), "ee_total": int(ee.shape[0]), "overflowed": False,
            "toi": toi, "solver_capped": capped, "ipc_refinements": refinements}


def frame(v0, v1, edges, faces, config: dict, options: dict, device, tile: int,
          control: bool = False) -> dict:
    """The answer for one frame; with ``control``, the control's: the same
    reference one precision below the configuration's."""
    validate(config, options)
    precision = config["precision"]
    out = ipc_frame(v0, v1, edges, faces, float(options.get("min_distance", 0.0)),
                    int(options.get("max_iterations", 1_000_000)),
                    float(options.get("tolerance", config["tolerance"])),
                    int(config["assumed"]["box_chunk_size"]["value"]), device,
                    precision=CONTROL[precision] if control else precision, tile=tile)
    # the answer a call gives: its refinements are pinned by the TOI
    del out["ipc_refinements"]
    return out
