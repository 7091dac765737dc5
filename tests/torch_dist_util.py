"""Process groups for the port's distributed tests (not collected).

A group is set up through a ``FileStore`` under the test's own temporary
directory (never a fixed TCP port, so test files running in parallel do
not collide) and torn down afterwards.
"""
import contextlib

import torch.distributed as dist


@contextlib.contextmanager
def gloo_world(store_path, rank: int = 0, world_size: int = 1):
    """A ``gloo`` world over ``store_path``, destroyed on exit."""
    dist.init_process_group("gloo", store=dist.FileStore(str(store_path),
                                                         world_size),
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
