"""Entry ``fused_ccd``: one call of the program's
``fused_ccd(v0, v1, edges, faces)`` on one frame, host float64 positions
in, ended when the caller holds the TOI and the overflow flag on the host,
what a simulator waits for before it steps."""


def call(program, v0, v1, edges, faces, device, options):
    res = program.fused_ccd(v0, v1, edges, faces, device=device, **options)
    res.toi.item(), res.overflowed.item()
    return res


def answer(res) -> dict:
    """A call's answer as host values, read once the window has closed."""
    return {"vf_total": int(res.vf_total), "ee_total": int(res.ee_total),
            "overflowed": bool(res.overflowed), "toi": float(res.toi),
            "solver_capped": bool(res.solver_capped)}
