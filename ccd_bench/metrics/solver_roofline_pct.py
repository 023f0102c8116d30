"""``solver_roofline_pct``: the least time the solver's bytes take at the
card's bandwidth (``ccd_bench/roofline.py``: every candidate's four
vertices at t=0 and t=1 and its two ids, read once, the candidates counted
by each call's ``vf_total + ee_total``) over kernel B's device time, in %.
Layer: solver."""

from ccd_bench import roofline

KERNELS = (r"\bsolve_kernel\b", r"\bsolve_lane_kernel\b")


def read(run):
    busy = run.device_s(KERNELS)
    if busy <= 0:
        return None
    need = sum(roofline.bound_s(roofline.solver_bytes(a["vf_total"] + a["ee_total"]))
               for a in run.answers)
    return 100.0 * need / busy
