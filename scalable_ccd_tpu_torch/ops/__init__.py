"""The hand-written CUDA kernels (``csrc/``), each beside its plain PyTorch
version: the sweep (:mod:`.sweep_ap`) and the solver (:mod:`.solver`)."""
