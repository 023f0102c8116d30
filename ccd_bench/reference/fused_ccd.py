"""Reference ``fused_ccd``: what the program's ``fused_ccd`` has to return
for one frame (:func:`ccd_bench.reference.reference_frame`): the exact
candidate counts, no overflow, the tight-inclusion TOI at the
configuration's ``tolerance`` and precision, and whether a query was
accepted at the runaway guard.

It models the entry point at its defaults: a cell whose configuration or
traffic passes the entry point a keyword (``call``) needs a reference of
its own that models it, ``reference/<name>.py`` with the same functions,
named by the traffic's or the configuration's ``reference``.
"""

from ccd_bench.reference import reference_frame

#: keywords of the entry point this reference models
OPTIONS = ()
#: the configuration's precision, and the control's one step below it
CONTROL = {"float32": "bfloat16"}


def validate(config: dict, options: dict) -> None:
    """Raises ``ValueError`` where the cell asks for what this reference
    does not model."""
    unmodelled = sorted(set(options) - set(OPTIONS))
    if unmodelled:
        raise ValueError(f"the reference does not model the options {unmodelled}")
    if config["precision"] not in CONTROL:
        raise ValueError(f"the reference does not model the precision {config['precision']!r}")


def frame(v0, v1, edges, faces, config: dict, options: dict, device, tile: int,
          control: bool = False) -> dict:
    """The answer for one frame; with ``control``, the control's: the same
    reference one precision below the configuration's."""
    validate(config, options)
    precision = config["precision"]
    return reference_frame(v0, v1, edges, faces, float(config["tolerance"]), device,
                           precision=CONTROL[precision] if control else precision, tile=tile)
