"""Device mesh helpers for multi-chip sharding.

The reference is OpenMP shared-memory only (SURVEY.md §2.13); here the
scaling axes are:
- ``reads`` (data parallel): read batches sharded across devices,
- ``kmer space``: hash-partitioned k-mer ownership with all_to_all
  exchange between devices (the analogue of the reference's
  hash-segment disk buckets, utils/kmer_mph/kmer_buckets.hpp:15-44).

The mesh is 1-D over every visible device: cards joined all to all
(NVLink) need no torus shape.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

READS_AXIS = "d"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (READS_AXIS,))


def shard_reads(mesh: Mesh, codes, lengths):
    """Place a read batch data-parallel over the mesh (pad R to multiple)."""
    import jax.numpy as jnp
    D = mesh.shape[READS_AXIS]
    R = codes.shape[0]
    pad = (-R) % D
    if pad:
        import numpy as _np
        codes = _np.concatenate(
            [codes, _np.full((pad, codes.shape[1]), 4, dtype=codes.dtype)])
        lengths = _np.concatenate([lengths,
                                   _np.zeros((pad,), lengths.dtype)])
    sh = NamedSharding(mesh, P(READS_AXIS, None))
    sh1 = NamedSharding(mesh, P(READS_AXIS))
    return jax.device_put(codes, sh), jax.device_put(lengths, sh1)


def auto_mesh() -> Mesh | None:
    """Mesh over all devices when more than one is visible, else None.

    Set ``SFB_FORCE_SINGLE_DEVICE=1`` to disable the distributed
    paths (used by equality tests comparing sharded vs single-device
    output)."""
    import os
    if os.environ.get("SFB_FORCE_SINGLE_DEVICE") == "1":
        return None
    if len(jax.devices()) <= 1:
        return None
    return make_mesh()
