"""Per-frame IPC stepping loop on PyTorch and CUDA (``ipc_ccd_strategy``).

Run:  python examples/ipc_loop_torch.py          (an NVIDIA GPU)
      python examples/ipc_loop_torch.py --cpu    (the plain versions)

The port's counterpart of ``examples/ipc_loop.py``.  Each frame queries the
earliest TOI of the proposed displacement and steps ``toi`` of the way.
The IPC rule (``ipc_ccd_strategy.cu:73-92``): a batch that drops the
running TOI below 1e-6 is solved again exactly from the TOI before it
(no minimum separation, no cap), and the step is scaled by 0.8, so a step
never lands inside the obstacle.
"""
import sys

import numpy as np

from scalable_ccd_tpu_torch import ipc_ccd_strategy
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere


def main(device):
    scene = cloth_on_sphere(grid_n=16, sphere_subdiv=2, drop=0.6)
    v = np.asarray(scene.vertices_t0, np.float64)
    target = np.asarray(scene.vertices_t1, np.float64)

    for frame in range(5):
        toi = ipc_ccd_strategy(v, target, scene.edges, scene.faces, min_distance=1e-3,
                               max_iterations=1_000_000, tolerance=1e-6, device=device)
        v = v + toi * (target - v)  # advance toi of the way
        print(f"frame {frame}: toi={toi:.6f}")
        if toi >= 1.0:
            print("full step taken: contact-free")
            break


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
