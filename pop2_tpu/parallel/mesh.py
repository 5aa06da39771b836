"""Device mesh and sharding for 2-D spatial domain decomposition.

Replacement for the reference's block decomposition + distribution
machinery (``source/blocks.F90``, ``source/distribution.F90``,
``source/domain.F90``): the horizontal (ny, nx) plane is sharded over a 2-D
logical mesh ('y', 'x'); the vertical and tracer dimensions are replicated
per shard (the reference never decomposes km/nt either — SURVEY.md §5.7).
XLA's SPMD partitioner inserts the halo exchanges (collective-permutes,
over NVLink between GPUs) for every shifted stencil access, subsuming
``mpi/POP_HaloMod.F90``, and turns masked ``jnp.sum`` reductions into
``psum`` trees, subsuming ``mpi/global_reductions.F90``.

Land-only blocks are NOT eliminated (the reference drops them,
``source/domain.F90:63-72``); dense sharding wastes those FLOPs and we account
for that in BASELINE.md. A space-filling-curve remap is a possible later
optimization for tx0.1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Tuple[int, int], devices=None) -> Mesh:
    """Create a (y, x) logical mesh. ``shape=(py, px)`` must multiply to the
    device count used."""
    if devices is None:
        devices = jax.devices()
    py, px = shape
    n = py * px
    if len(devices) < n:
        raise ValueError(f"mesh {shape} needs {n} devices, "
                         f"have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(py, px)
    return Mesh(dev, axis_names=("y", "x"))


def spec_for(arr) -> P:
    """PartitionSpec sharding the trailing two axes as (y, x); smaller-rank
    arrays (vertical profiles, scalars) are replicated."""
    ndim = getattr(arr, "ndim", 0)
    if ndim >= 2:
        return P(*([None] * (ndim - 2) + ["y", "x"]))
    return P()


def shard_pytree(tree, mesh: Mesh):
    """Place every leaf with the (y, x) trailing-axes sharding."""
    def place(leaf):
        return jax.device_put(leaf, NamedSharding(mesh, spec_for(leaf)))
    return jax.tree_util.tree_map(place, tree)


def sharded_model(cfg, mesh: Optional[Mesh] = None):
    """Build a Model whose grid/forcing live sharded on ``mesh``; returns
    (model, mesh). The step function needs no changes — XLA partitions it
    from the input shardings."""
    from pop2_tpu.model import Model
    model = Model(cfg)
    # per-shard Thomas kernel dispatch: Model derives its mesh from
    # cfg.mesh_shape; an explicitly provided mesh (e.g. pre-built over
    # specific devices) overrides it before the step first traces
    if mesh is None:
        mesh = model._mesh if model._mesh is not None \
            else make_mesh(cfg.mesh_shape)
    model._mesh = mesh
    model.grid = shard_pytree(model.grid, mesh)
    model.forcing = shard_pytree(model.forcing, mesh)
    if model.ts_range is not None:
        model.ts_range = jax.tree_util.tree_map(
            lambda a: jax.device_put(
                a, NamedSharding(mesh, P())), model.ts_range)
    return model, mesh
