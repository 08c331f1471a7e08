"""Device-mesh construction and sharding helpers.

The reference scales two ways: a pthread pool over pixel blocks inside one
process (``/root/reference/src/test.cpp:147-308``) and a TCP render farm
across hosts (``test.cpp:520-793``).  The counterpart here is one
mechanism: a ``jax.sharding.Mesh`` whose axes shard the *pixel* axis
("tiles") and the *sample* axis ("samples"); XLA collectives over the
device interconnect replace both the worker queue and the ASCII pixel
protocol.  The mesh follows the algorithm, not a physical topology:
every card of an NVLink host reaches every other at the same rate.

Axis layout:

- ``tiles``: image rows sharded across devices — the moral equivalent of
  the 32-px block decomposition; zero communication until the host gather.
- ``samples``: samples-per-pixel sharded — each device renders the full
  (local) tile at ``spp / samples`` and a ``psum`` mean combines them; this
  is the renderer's "gradient allreduce" twin, and the axis gradients
  reduce over in training.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(devices=None, tiles: int | None = None, samples: int = 1) -> Mesh:
    """Build a (tiles, samples) mesh.  Defaults: all devices on the tile
    axis.  ``tiles`` is inferred when omitted."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if tiles is None:
        tiles = n // samples
    if tiles * samples != n:
        raise ValueError(f"{tiles}×{samples} mesh != {n} devices")
    arr = np.asarray(devices).reshape(tiles, samples)
    return Mesh(arr, (TILE_AXIS, SAMPLE_AXIS))


def image_sharding(mesh: Mesh) -> NamedSharding:
    """(H, W, 3) images: rows sharded over tiles, replicated over samples."""
    return NamedSharding(mesh, P(TILE_AXIS, None, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_params(params, mesh: Mesh):
    """Scene parameters are small (SoA tables + textures): replicate.
    Texture images could shard over samples for very large environment maps;
    replication is the right default below ~100 MB."""
    rep = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, rep), params)
