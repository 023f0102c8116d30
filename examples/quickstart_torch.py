"""Fused CCD on PyTorch and CUDA: TOI, per-pair hits, stats.

Run:  python examples/quickstart_torch.py          (an NVIDIA GPU)
      python examples/quickstart_torch.py --cpu    (the plain versions)

The port's counterpart of ``examples/quickstart.py``: the earliest time of
impact over all vertex-face and edge-edge pairs of a linearly moving
triangle mesh (``fused_ccd``), the per-pair hit list as an option, and the
chunked pipeline with its per-stage stats.  Entry points run on CUDA
unless ``device`` names another device.
"""
import sys

from scalable_ccd_tpu_torch import CCDConfig, CCDStats, ccd, fused_ccd
from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere


def main(device):
    # a cloth grid dropping onto a sphere between t=0 and t=1
    scene = cloth_on_sphere(grid_n=24, sphere_subdiv=2, drop=0.5)
    args = (scene.vertices_t0, scene.vertices_t1, scene.edges, scene.faces)

    res = fused_ccd(*args, device=device)  # budgets and knobs resolved automatically
    print(f"fused_ccd: toi={float(res.toi):.6f} "
          f"candidates vf={int(res.vf_total)} ee={int(res.ee_total)} "
          f"overflowed={bool(res.overflowed)}")

    hits = []
    fused_ccd(*args, device=device, collisions=hits)
    print(f"collisions: {len(hits)} pairs with toi < 1; earliest "
          f"{min((t for _, _, t in hits), default=1.0):.6f}")

    stats = CCDStats()
    toi = ccd(*args, config=CCDConfig(), stats=stats, device=device)
    print(f"ccd (chunked): toi={toi:.6f} broad={stats.broad_time_s:.3f}s "
          f"narrow={stats.narrow_time_s:.3f}s checks={stats.narrow_checks}")


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
