"""Multi-device scaling: shard the frame batch over a device mesh.

The reference's only parallelism is frame-level task parallelism on the VS
thread pool plus SIMD lanes (SURVEY §2.3).  The batched equivalent is a
1-D ``frames`` mesh axis: every filter is embarrassingly parallel over the
leading (N, H, W) batch axis, so data parallelism over frames needs
no communication for spatial filters; metric filters (PlaneAverage,
PlaneMinMax, XPSNR, SSIMULACRA2) reduce with a single XLA collective that
jit inserts from the sharding annotations; temporal filters (Checkmate,
XPSNR temporal, CombMask motion) take a +/-2-frame halo which we realize by
overlapping shards (cheap, stateless) rather than ppermute.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.clip import Clip

FRAMES_AXIS = "frames"


def frames_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over `n_devices` (default: all visible devices).

    Raises if fewer than `n_devices` devices are visible — a silently
    truncated mesh would let multi-chip tests "pass" on one device.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise RuntimeError(
                    f"frames_mesh: requested {n_devices} devices but only "
                    f"{len(devices)} visible "
                    f"({devices[0].platform}); for a virtual CPU mesh set "
                    f"XLA_FLAGS=--xla_force_host_platform_device_count="
                    f"{n_devices} and jax.config.update('jax_platforms', "
                    f"'cpu') before JAX initializes"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (FRAMES_AXIS,))


def _plane_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(FRAMES_AXIS, None, None))


def shard_clip(clip: Clip, mesh: Mesh) -> Clip:
    """Place a clip's planes sharded over frames.  N must divide the mesh."""
    sh = _plane_sharding(mesh)
    planes = tuple(jax.device_put(jax.numpy.asarray(p), sh) for p in clip.planes)
    return clip.with_planes(planes)


def replicate_clip(clip: Clip, mesh: Mesh) -> Clip:
    sh = NamedSharding(mesh, P(None, None, None))
    planes = tuple(jax.device_put(jax.numpy.asarray(p), sh) for p in clip.planes)
    return clip.with_planes(planes)
