"""The comparison that decides ``correct``: every call of the window
against the plain reference of its frame.  A reference model
(``reference/<name>.py``) whose answers hold other numbers brings its own
``LIMITS`` and ``compare``; these are the default.

Each call returns, for its frame, the broad phase's exact candidate counts
(``vf_total``, ``ee_total``) and overflow flag, and the narrow phase's TOI
and ``solver_capped``.  The numbers compared, each the worst over the
calls, with its limit (``PERF.md`` gives the readings each was set from):

- ``vf_total_gap``, ``ee_total_gap``: the gap between the counts; exact;
- ``overflowed_calls``: calls that report a pair budget overflowed, with
  candidates missing; the reference has none;
- ``toi_gap``: the gap between the TOIs; the port's TOI is the reference's
  bit for bit, whatever order its kernels search in;
- ``capped_mismatch``: calls whose ``solver_capped`` differs from the
  reference's.
"""

from __future__ import annotations

__all__ = ["LIMITS", "compare"]

#: numbers that count calls over a run; the others are the worst call's
COUNTED = ("overflowed_calls", "capped_mismatch")

LIMITS = {
    "vf_total_gap": 0,
    "ee_total_gap": 0,
    "overflowed_calls": 0,
    "toi_gap": 0.0,
    "capped_mismatch": 0,
}


def compare(calls, refs: dict) -> tuple[dict, int]:
    """``(numbers, wrong)``: the compared numbers over ``calls``, a list of
    ``(frame, answer)``, against ``refs[frame]``, and the calls with any
    number of their own over its limit."""
    worst = {name: 0 * limit for name, limit in LIMITS.items()}
    wrong = 0
    for k, a in calls:
        r = refs[k]
        own = {
            "vf_total_gap": abs(a["vf_total"] - r["vf_total"]),
            "ee_total_gap": abs(a["ee_total"] - r["ee_total"]),
            "overflowed_calls": int(a["overflowed"]),
            "toi_gap": abs(a["toi"] - r["toi"]),
            "capped_mismatch": int(a["solver_capped"] != r["solver_capped"]),
        }
        for name, v in own.items():
            if name in COUNTED:
                worst[name] += v
            else:
                worst[name] = max(worst[name], v)
        wrong += any(v > LIMITS[name] for name, v in own.items())
    return worst, wrong
