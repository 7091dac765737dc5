"""Device meshes over the ranks of a ``torch.distributed`` world.

Port of ``repro.launch.mesh``. Functions only: importing this module
touches no process group. The caller initialises the world first
(``torch.distributed.init_process_group``, with its address, world size
and rank given explicitly: nothing on a host tells a program of its
cluster).

The reference's production shapes, (data=16, model=16) and
(pod=2, data=16, model=16), are TPU pod facts. The port keeps their axis
names and takes the shape from the world size: every rank on ``data``
(the ODM solvers are data parallel; the model axis has size 1), split
over two pods when ``multi_pod``. A world that does not split raises.
"""
from __future__ import annotations

from repro_torch.sharding import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """A mesh over every rank of the world, one rank a card: axes
    ("data", "model"), or ("pod", "data", "model") with two pods."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: initialise the world (nccl, one rank a "
            "card) before making the production mesh")
    world = dist.get_world_size()
    if not multi_pod:
        return make_mesh((world, 1), ("data", "model"))
    if world % 2 != 0:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"two pods")
    return make_mesh((2, world // 2, 1), ("pod", "data", "model"))


def make_host_mesh(shape=(2, 4), axes=("data", "model")):
    """A mesh over the CPU ranks of a ``gloo`` world, for distributed
    tests at CI scale."""
    return make_mesh(shape, axes, device_type="cpu")
