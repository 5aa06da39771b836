"""Multi-host (multi-process) scaffolding: distributed runtime init, global
meshes, and host-local data movement.

The reference's entire communication layer exists to run one ocean across
many processes (``mpi/POP_CommMod.F90`` init_communicate, MPI_Init;
``mpi/POP_HaloMod.F90`` ghost updates; ``mpi/gather_scatter.F90``). The JAX
equivalent is: ``jax.distributed.initialize`` (one JAX process per host,
all hosts see the global device list), a ``Mesh`` spanning every process's
devices, and ``jax.make_array_from_process_local_data`` /
``multihost_utils`` for host<->global movement. XLA then partitions the
jitted step exactly as in the single-process case — the same model code runs
1-host or N-host.

Checkpointing across hosts uses orbax/tensorstore (``sharded_restart.py``):
every process writes its own shards, replacing the reference's
gather-to-rank-0 restart writes (``source/restart.F90`` + gather_scatter).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pop2_tpu.parallel.mesh import spec_for


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids=None) -> int:
    """Bring up the distributed JAX runtime (the analogue of
    init_communicate, mpi/POP_CommMod.F90:64-105). On CPU/GPU clusters
    pass the coordinator address, process count and id explicitly. Idempotent: returns the process index, initializing
    only on the first call. Single-process callers may skip this entirely.
    """
    # no jax.devices()/process_count() probes before initialize: any backend
    # touch forecloses distributed init (jax raises). Track via jax's own
    # distributed global state instead.
    from jax._src import distributed as _dist
    if coordinator_address is None or _dist.global_state.client is not None:
        return jax.process_index()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    return jax.process_index()


def global_mesh(shape: Tuple[int, int]) -> Mesh:
    """A (y, x) mesh over the GLOBAL device list — after
    ``initialize_distributed``, ``jax.devices()`` spans every process, so
    the same mesh-construction path as single-host covers pods/clusters."""
    py, px = shape
    n = py * px
    devices = jax.devices()
    if len(devices) != n:
        raise ValueError(
            f"mesh {shape} needs exactly the {len(devices)} global devices "
            f"(got {n}); choose shape to match the pod slice")
    dev = np.asarray(devices).reshape(py, px)
    return Mesh(dev, axis_names=("y", "x"))


def make_global_array(local_data, mesh: Mesh, spec: Optional[P] = None):
    """Assemble a global sharded array from per-process host data (the
    inverse of the reference's scatter_global, mpi/gather_scatter.F90:1348):
    each process provides ITS slab of the (ny, nx)-trailing array."""
    if spec is None:
        spec = spec_for(local_data)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_data)


def to_host_replicated(arr):
    """Gather a (possibly sharded) global array to a fully-replicated numpy
    array on every host (gather_global, mpi/gather_scatter.F90:74: the
    rank-0 gather, except every host gets the field — needed for host-side
    output writers)."""
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(
        arr, tiled=True))


def process_local_slice(global_shape, mesh: Mesh, spec: P):
    """The index slab of the global array owned by this process (for
    process-local file reads: each host loads only its part of the grid /
    forcing files — replacing read-on-rank-0 + scatter)."""
    sharding = NamedSharding(mesh, spec)
    # union of the addressable devices' shards
    idx = sharding.addressable_devices_indices_map(tuple(global_shape))
    slices = list(idx.values())
    lo = [min(s[d].start or 0 for s in slices)
          for d in range(len(global_shape))]
    hi = [max(s[d].stop if s[d].stop is not None else global_shape[d]
              for s in slices) for d in range(len(global_shape))]
    return tuple(slice(l, h) for l, h in zip(lo, hi))
