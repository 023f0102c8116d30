"""Entry ``ipc_ccd_strategy``: one call of the program's
``ipc_ccd_strategy(v0, v1, edges, faces, **options)`` on one frame, the
chunked path at the default configuration, host float64 positions in; it
returns the TOI as a float, so the call ends when the caller holds it, what
an IPC stepper waits for before it takes its step.  The call's counts come
back through the ``CCDStats`` it is given."""


def call(program, v0, v1, edges, faces, device, options):
    stats = program.CCDStats()
    toi = program.ipc_ccd_strategy(v0, v1, edges, faces, impl="chunked",
                                   config=program.DEFAULT_CONFIG, stats=stats, device=device,
                                   **options)
    return toi, stats


def answer(res) -> dict:
    """A call's answer as host values, read once the window has closed."""
    toi, stats = res
    return {"vf_total": int(stats.vf_candidates), "ee_total": int(stats.ee_candidates),
            "overflowed": False, "toi": float(toi),
            "solver_capped": stats.overflow_queries > 0}
