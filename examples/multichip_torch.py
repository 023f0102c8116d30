"""Multi-device CCD on ``torch.distributed`` (``sharded_ccd``).

Run:  python examples/multichip_torch.py [ranks]          (a GPU per rank: NCCL)
      python examples/multichip_torch.py [ranks] --cpu    (CPU processes: gloo)

The port's counterpart of ``examples/multichip.py``.  ``spawn_local``
starts one process per rank, joined in one process group (NCCL where every
rank has a card of its own, gloo otherwise).  Each rank sweeps its share of
the sorted boxes, the candidates are pooled and striped across the ranks
(one all-gather per phase), and the running TOI is all-reduced after every
narrow batch so the ranks prune each other mid-search.
Under ``partition="box"`` each rank still builds and sorts the whole box
arrays, then keeps only its owned share of the sorted order plus a halo
through the sweep and the narrow phase.
"""
import sys

from scalable_ccd_tpu_torch.parallel import spawn_local


def rank_main(device):
    import torch.distributed as dist

    from scalable_ccd_tpu_torch import sharded_ccd
    from scalable_ccd_tpu_torch.geometry.scenes import cloth_on_sphere

    scene = cloth_on_sphere(grid_n=24, sphere_subdiv=2, drop=0.5)
    args = (scene.vertices_t0, scene.vertices_t1, scene.edges, scene.faces)
    kw = dict(device=device, vf_budget_per_shard=1 << 14, ee_budget_per_shard=1 << 14)
    res = sharded_ccd(*args, **kw)
    box = sharded_ccd(*args, partition="box", **kw)
    return (dist.get_rank(), float(res.toi), int(res.vf_total), int(res.ee_total),
            bool(res.overflowed), float(box.toi))


def main():
    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    ranks = int(argv[0]) if argv else 2
    device = "cpu" if "--cpu" in sys.argv[1:] else None
    for rank, toi, vf, ee, over, box_toi in spawn_local(ranks, rank_main, device):
        print(f"rank {rank}: sharded_ccd toi={toi:.6f} vf={vf} ee={ee} overflowed={over}; "
              f"partition='box' toi={box_toi:.6f}")


if __name__ == "__main__":
    main()
