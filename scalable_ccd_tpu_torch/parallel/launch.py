"""Local process groups for the multi-device path.

:func:`spawn_local` runs a function in ``world`` local processes, each a rank
of one ``torch.distributed`` process group joined through a file store, and
returns each rank's result; :func:`dryrun_multichip` is the counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip`` (one replicated step
and one ``partition="box"`` step, whose TOIs must agree).

The backend: ``nccl`` where every rank has a card of its own, ``gloo``
otherwise (CPU processes, or several ranks sharing one card, which NCCL
refuses).  A backend that was asked for is used as it is, or the run
fails; nothing switches silently.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["dryrun_multichip", "pick_backend", "spawn_local"]

#: seconds a rank may wait in one collective before the group gives up
#: (and the seconds spawn_local waits for all ranks' results)
TIMEOUT_S = 600

#: seconds between checks that no rank died without reporting
_POLL_S = 1.0


def pick_backend(world: int) -> str:
    """``"nccl"`` when CUDA has at least ``world`` devices (a card per
    rank), else ``"gloo"``."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank, world, backend, init, results, fn, args):
    """One rank: join the group, run ``fn(*args)``, report ``(rank, ok,
    value or traceback)``."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(world: int, fn, *args, backend=None):
    """Run ``fn(*args)`` in ``world`` new processes, ranks ``0 .. world-1`` of
    one process group, and return their results in rank order.

    ``fn`` must be importable by name (the processes are spawned, so it is
    pickled by its import path), and so must its results.  ``backend=None``
    is :func:`pick_backend`'s choice.  If a rank raises, the others are
    stopped and ``RuntimeError`` carries the rank's traceback; so it does
    when a rank dies without reporting, or when the ranks take more than
    :data:`TIMEOUT_S` seconds.
    """
    backend = pick_backend(world) if backend is None else backend
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out, failed = [None] * world, None
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, init, results, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            waited, pending = 0.0, world
            while pending and failed is None:
                try:
                    rank, ok, value = results.get(timeout=_POLL_S)
                except queue.Empty:
                    waited += _POLL_S
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        failed = f"ranks {dead} exited with codes " + str(
                            [procs[r].exitcode for r in dead]) + " before reporting"
                    elif waited >= TIMEOUT_S:
                        failed = f"the ranks did not finish within {TIMEOUT_S} s"
                    continue
                pending -= 1
                if not ok:
                    failed = f"rank {rank} of {world} ({backend}) failed:\n{value}"
                out[rank] = value
        finally:
            for p in procs:
                if failed is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed is not None:
        raise RuntimeError(f"spawn_local: {failed}")
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn_local: ranks exited with codes {bad}")
    return out


def _dryrun_rank(device):
    """One rank of :func:`dryrun_multichip`: ``(toi, box_toi, overflowed)``."""
    from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere
    from scalable_ccd_tpu_torch.parallel.sharded import make_sharded_ccd

    s = cloth_on_sphere(grid_n=8, sphere_subdiv=0, drop=0.5)
    args = (s.vertices_t0, s.vertices_t1, s.edges, s.faces)
    kw = dict(device=device, vf_budget_per_shard=1 << 10, ee_budget_per_shard=1 << 10)
    res = make_sharded_ccd(max_iterations=1 << 14, **kw)(*args)
    box = make_sharded_ccd(partition="box", halo_boxes=1 << 10, **kw)(*args)
    return float(res.toi), float(box.toi), bool(res.overflowed) or bool(box.overflowed)


def dryrun_multichip(n: int, backend=None, device=None) -> None:
    """One replicated sharded step and one ``partition="box"`` step over
    ``n`` local ranks (JAX ``__graft_entry__.py:48-93``): the TOIs must lie
    in [0, 1], agree within 1e-5 (the first is bounded at 2^14 checks per
    query, the second not) and not overflow.  ``device`` is each rank's
    (``None``: its card, :func:`scalable_ccd_tpu_torch.parallel.sharded.
    rank_device`); ``backend=None`` is :func:`pick_backend`'s choice, and
    the backend used is printed."""
    backend = pick_backend(n) if backend is None else backend
    out = spawn_local(n, _dryrun_rank, device, backend=backend)
    toi, box_toi, overflowed = out[0]
    if any(o != out[0] for o in out):
        raise AssertionError(f"ranks disagree: {out}")
    if overflowed or not 0.0 <= toi <= 1.0 or abs(box_toi - toi) >= 1e-5:
        raise AssertionError(f"dryrun_multichip({n}): toi {toi}, partition=box {box_toi}, "
                             f"overflowed {overflowed}")
    print(f"dryrun_multichip({n}, backend={backend}): toi={toi:.6f} overflowed=False")
    print(f"dryrun_multichip({n}, backend={backend}): partition=box toi matches")
