"""Multi-host initialization and global meshes.

SURVEY.md §5.9's answer: per-host `jax.distributed`
initialization, a global (data, tile) mesh spanning all hosts, and
host-local shard assembly for entropy-coded outputs (each host boolean-
codes the token partitions of its own stripes; the per-partition size
table stitches them, mirroring the format's EmitPartitionsSize).

Multi-host hardware is not available in this environment; the sharding
code paths are exercised on the virtual 8-device CPU mesh in tests.
"""

from __future__ import annotations

import jax

from .mesh import make_mesh

_initialized = False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize jax.distributed once per host (no-op on single host)."""
    global _initialized
    if _initialized:
        return
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    _initialized = True


def global_mesh(tile: int | None = None):
    """A (data, tile) mesh over every device in the job.

    Keep `tile` within one host's chip count so halo ppermutes ride ICI;
    the data axis spans hosts (DCN only sees independent images).
    """
    n = len(jax.devices())
    local = len(jax.local_devices())
    if tile is None:
        tile = min(local, 4)
        while n % tile:
            tile //= 2
    return make_mesh(n, tile=tile)


__all__ = ["initialize", "global_mesh"]
