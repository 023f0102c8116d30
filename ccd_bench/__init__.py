"""The benchmark of the PyTorch and CUDA port, ``scalable_ccd_tpu_torch``.

``python3 ccd_bench/run.py --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once on the card and prints one
JSON line (``BENCHMARK.json`` at the repository's root lists the cells and
metrics).  Configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``) and metrics (``metrics/<name>.py``) are found by
name.  The plain reference that decides ``correct`` is in ``reference/``.
Nothing here imports jax or the JAX package.
"""
