"""``sweep_roofline_pct``: the least time the sweeps' bytes take at the
card's bandwidth (``ccd_bench/roofline.py``: every box of both phases read
once, every candidate pair written once, the pairs counted by each call's
``vf_total + ee_total``) over the device time of kernels A and A', in %.
Layer: sweep."""

from ccd_bench import roofline

#: kernel A's and kernel A''s launches, by function name
KERNELS = (r"\btile_units_kernel\b", r"\bunit_prefix_kernel\b", r"\bsweep_units_kernel\b",
           r"\brecord_units_kernel\b", r"\bsweep_records_kernel\b")


def read(run):
    busy = run.device_s(KERNELS)
    if busy <= 0:
        return None
    need = sum(roofline.bound_s(roofline.sweep_bytes(
        run.n_vf_boxes, run.n_ee_boxes, a["vf_total"] + a["ee_total"])) for a in run.answers)
    return 100.0 * need / busy
