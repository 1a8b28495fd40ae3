"""Device-mesh construction for multi-chip/multi-host runs.

The codec shards along two axes (SURVEY.md §2.10's mapping):
  - "data": batch of images → pure data parallelism
  - "tile": spatial tiles within an image → halo exchange between
    devices (NVLink on a multi-GPU host)

Equivalent reference surface: none (the reference is single-process;
§2.10 catalogues its thread-level parallelism, which batch/tile sharding
subsumes).
"""

from __future__ import annotations

import math

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, *, data: int | None = None,
              tile: int | None = None) -> Mesh:
    """Build a (data, tile) mesh over the available devices.

    Default split: as many tile shards as divide the device count by the
    largest power of two ≤ sqrt(n), rest data-parallel.
    """
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    devices = devices[:n]
    if data is None and tile is None:
        tile = 1 << int(math.log2(max(1, int(math.sqrt(n)))))
        while n % tile:
            tile //= 2
        data = n // tile
    elif data is None:
        data = n // tile
    elif tile is None:
        tile = n // data
    if data * tile != n:
        raise ValueError(f"mesh {data}x{tile} != {n} devices")
    import numpy as np

    return Mesh(np.array(devices).reshape(data, tile), ("data", "tile"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch axis over 'data' and width over 'tile'."""
    return NamedSharding(mesh, P("data", None, "tile"))


__all__ = ["make_mesh", "batch_sharding"]
