"""Configuration of the chunked pipeline (:func:`scalable_ccd_tpu_torch.ccd`).

PyTorch counterpart of ``scalable_ccd_tpu/config.py``: the same two frozen
dataclasses with the same field names and defaults, so a configuration can
be handed to both packages (``interop.config_from_jax``).  Fields that pick
something this port does not have are kept for that reason and rejected by
:func:`check_supported`, which :func:`scalable_ccd_tpu_torch.ccd` calls on
entry; the error names the ROADMAP item the feature waits for.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = [
    "CCDConfig",
    "MemoryConfig",
    "DEFAULT_CONFIG",
    "check_supported",
    "normalize_round_limits",
]


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """Chunk and batch sizes (the reference's ``MemoryHandler``,
    ``cuda/memory_handler.hpp:7-39``, with static sizes)."""

    #: sorted boxes swept per broad-phase chunk (the chunk cursor's stride,
    #: the reference's MAX_OVERLAP_CUTOFF, ``memory_handler.hpp:9``)
    box_chunk_size: int = 1 << 15

    #: pair buffer rows of one chunk's sweep; a chunk with more survivors
    #: retries once at its exact total (MAX_OVERLAP_SIZE, ``:11``)
    pair_chunk_size: int = 1 << 20

    #: narrow-phase batch sizes; the port cuts batches at the largest and
    #: pads nothing (the JAX package pads to the menu to bound its compiled
    #: shapes; MAX_QUERIES, ``:15``)
    query_buckets: Tuple[int, ...] = (1 << 12, 1 << 14, 1 << 16, 1 << 17)

    #: read only by the JAX package's exact slot-decode sweep; kept so that
    #: configurations carry over
    max_pairs_per_box_chunk: int = 1 << 30

    #: memory cap in GB (the reference's ``memory_limit_GB``); a positive
    #: value scales the chunk sizes down (:meth:`scaled`)
    memory_limit_GB: float = 0.0

    def scaled(self) -> "MemoryConfig":
        """Apply ``memory_limit_GB``: a cap of G GB scales the chunk sizes
        by G/16, floored to powers of two (the JAX package's rule)."""
        if self.memory_limit_GB <= 0:
            return self
        frac = min(1.0, self.memory_limit_GB / 16.0)
        shift = 0
        while (1.0 / (1 << (shift + 1))) >= frac and shift < 8:
            shift += 1
        return dataclasses.replace(
            self,
            box_chunk_size=max(1024, self.box_chunk_size >> shift),
            pair_chunk_size=max(4096, self.pair_chunk_size >> shift),
            query_buckets=tuple(max(1024, q >> shift) for q in self.query_buckets),
        )


@dataclasses.dataclass(frozen=True)
class CCDConfig:
    """The knobs of :func:`scalable_ccd_tpu_torch.ccd` (``cuda::ccd``'s
    parameters, ``cuda/ccd.cuh:26-38``, plus the reference's build
    options).  As in the JAX package, ``ccd()`` takes ``tolerance``,
    ``max_iterations`` and ``allow_zero_toi`` from its own arguments; the
    fields of the same names are carried for the JAX configuration's sake.
    """

    #: working precision; only "float32" is ported (f64 is ROADMAP item 5)
    dtype: str = "float32"

    #: inclusion-function precision: "f32"; "compensated" waits for item 5
    precision: str = "f32"

    #: co-domain tolerance of the root finder
    tolerance: float = 1e-6

    #: domain checks per query, -1 = unbounded
    max_iterations: int = -1

    #: allow a time of impact of exactly zero
    allow_zero_toi: bool = True

    #: prune each query only against its own TOI (the reference's
    #: TOI_PER_QUERY build); collisions mode implies it
    toi_per_query: bool = False

    #: TOI warm-start batch per broad chunk: "auto" (below 2^20 boxes per
    #: phase, as in the JAX package), True or False; off under collisions
    presample: object = "auto"

    #: the JAX package's choice between its own sweeps; the port has one
    #: (kernel A with a box range), so only "auto"
    broad_impl: str = "auto"

    #: the JAX package's choice between its own solvers; the port has one
    #: (kernel B), so only "auto"
    solver: str = "auto"

    #: staged escalation of the solver's global solves: -2 (auto: 128
    #: rounds without an iteration cap, else off), -1 (off), a round limit
    #: >= 0, or a strictly ascending ladder of limits
    escalate_rounds: object = -2

    #: read only by the JAX package's "dfs" solver; kept so that
    #: configurations carry over
    stack_capacity: int = 96

    #: chunking policy
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)

    def replace(self, **kw) -> "CCDConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = CCDConfig()


def normalize_round_limits(round_limit) -> tuple:
    """``round_limit`` as a tuple of bounded-pass limits: ``None`` or a
    negative int -> ``()`` (one unbounded pass), an int ``>= 0`` -> one
    bounded stage, a tuple or list -> a ladder, which must be non-negative
    and strictly ascending (``_normalize_round_limits``, JAX
    ``pallas_solver.py:724-742``)."""
    if round_limit is None:
        return ()
    if isinstance(round_limit, (tuple, list)):
        limits = tuple(int(r) for r in round_limit)
        if any(r < 0 for r in limits):
            raise ValueError(f"negative round limit in ladder {limits!r}")
        if any(a >= b for a, b in zip(limits, limits[1:])):
            raise ValueError(f"escalation ladder must be strictly ascending: {limits!r}")
        return limits
    return (int(round_limit),) if round_limit >= 0 else ()


def check_supported(config: CCDConfig) -> None:
    """Raise ``ValueError`` for a value that picks something the port does
    not have."""
    if config.dtype != "float32":
        raise ValueError(
            f"dtype={config.dtype!r} is not ported: only float32 "
            "(f64 is ROADMAP item 5)"
        )
    if config.precision != "f32":
        raise ValueError(
            f"precision={config.precision!r} is not ported: only 'f32' "
            "(the compensated mode is ROADMAP item 5)"
        )
    normalize_round_limits(config.escalate_rounds)  # a bad ladder raises
    for name in ("solver", "broad_impl"):
        value = getattr(config, name)
        if value != "auto":
            raise ValueError(
                f"{name}={value!r}: this value chooses between the JAX "
                "package's implementations; the port has one, so only 'auto'"
            )
    if config.presample not in ("auto", None, True, False):
        raise ValueError(f"presample={config.presample!r}: 'auto', True or False")
