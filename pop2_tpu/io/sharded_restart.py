"""Sharded (multi-host-capable) checkpointing via orbax/tensorstore.

Reference: ``source/restart.F90`` writes the full prognostic state through
gather-to-master netCDF/binary IO. The sharded replacement keeps every
shard on its owning process: orbax writes a tensorstore array per State
field with the sharding recorded, so N processes write N slabs in parallel
and restore re-establishes the same (or a compatible) sharding — no
gather/scatter, no single-writer bottleneck. The npz path (``restart.py``)
remains the single-host/portable format; this is the scale path
(SURVEY.md §5.4: "orbax/tensorstore sharded checkpoint").
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax

from pop2_tpu.config import ModelConfig
from pop2_tpu.state import State

POINTER_FILE = "rpointer.ocn.sharded"


def _manager(directory: str):
    import orbax.checkpoint as ocp
    return ocp.CheckpointManager(directory)


def write_sharded_restart(directory: str, state: State, nsteps_total: int,
                          cfg: ModelConfig) -> str:
    """Write a sharded checkpoint at step ``nsteps_total``; returns the
    checkpoint directory. Every process participates (collective)."""
    import orbax.checkpoint as ocp
    directory = os.path.abspath(directory)
    with ocp.CheckpointManager(directory) as mgr:
        mgr.save(nsteps_total, args=ocp.args.StandardSave(
            {"state": dataclasses.asdict(state),
             "meta": {"nsteps_total": nsteps_total, "nx": cfg.nx,
                      "ny": cfg.ny, "km": cfg.km, "nt": cfg.nt}}))
        mgr.wait_until_finished()
    if jax.process_index() == 0:
        with open(os.path.join(directory, POINTER_FILE), "w") as f:
            f.write(f"{nsteps_total}\n")
    return directory


def read_sharded_restart(directory: str, cfg: ModelConfig,
                         step: Optional[int] = None,
                         shardings=None) -> Tuple[State, int]:
    """Restore (state, nsteps_total); ``shardings`` optionally a State-shaped
    pytree of NamedShardings to restore directly onto a mesh (each process
    reads only its slabs)."""
    import orbax.checkpoint as ocp
    directory = os.path.abspath(directory)
    with ocp.CheckpointManager(directory) as mgr:
        if step is None:
            step = mgr.latest_step()
        restored = mgr.restore(step)
    st = restored["state"]
    meta = restored["meta"]
    for dim in ("nx", "ny", "km", "nt"):
        if int(meta[dim]) != getattr(cfg, dim):
            raise ValueError(
                f"sharded restart {dim}={meta[dim]} != config "
                f"{getattr(cfg, dim)}")
    state = State(**st)
    if shardings is not None:
        state = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, s), state, shardings)
    return state, int(meta["nsteps_total"])
