"""Multi-host scaffolding: global-array assembly, host gathers, sharded
checkpointing, and a 2-process distributed-runtime smoke test
(mpi/POP_CommMod.F90 / gather_scatter.F90 / restart.F90 equivalents)."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pop2_tpu.config import get_config
from pop2_tpu.parallel import multihost
from pop2_tpu.parallel.mesh import make_mesh, shard_pytree, spec_for


def test_make_global_array_and_gather():
    """Single-process degenerate case of the multi-host path: local data ==
    global data; the array lands sharded on the mesh and gathers back."""
    mesh = make_mesh((2, 4))
    data = np.arange(24 * 32, dtype=np.float64).reshape(24, 32)
    garr = multihost.make_global_array(data, mesh)
    assert garr.shape == (24, 32)
    back = multihost.to_host_replicated(garr)
    np.testing.assert_array_equal(back, data)


def test_process_local_slice_single_process():
    from jax.sharding import PartitionSpec as P
    mesh = make_mesh((2, 4))
    sl = multihost.process_local_slice((24, 32), mesh, P("y", "x"))
    # single process owns everything
    assert sl == (slice(0, 24), slice(0, 32))


def test_sharded_restart_roundtrip(tmp_path):
    from pop2_tpu.io.sharded_restart import (read_sharded_restart,
                                             write_sharded_restart)
    from pop2_tpu.model import Model
    cfg = get_config("mini")
    m = Model(cfg)
    s = m.initial_state()
    s, _ = m.advance(s)
    write_sharded_restart(str(tmp_path / "ckpt"), s, 1, cfg)
    s2, n = read_sharded_restart(str(tmp_path / "ckpt"), cfg)
    assert n == 1
    for name in ("tracer_cur", "u_cur", "psurf_cur", "qice"):
        np.testing.assert_array_equal(np.asarray(getattr(s, name)),
                                      np.asarray(getattr(s2, name)),
                                      err_msg=name)


def test_sharded_restart_restores_onto_mesh(tmp_path):
    """Restore directly onto a device mesh (each process would read only its
    slabs in the multi-host case)."""
    from jax.sharding import NamedSharding
    from pop2_tpu.io.sharded_restart import (read_sharded_restart,
                                             write_sharded_restart)
    from pop2_tpu.model import Model
    cfg = get_config("mini")
    m = Model(cfg)
    s = m.initial_state()
    write_sharded_restart(str(tmp_path / "ckpt"), s, 0, cfg)
    mesh = make_mesh((2, 2))
    shardings = jax.tree_util.tree_map(
        lambda a: NamedSharding(mesh, spec_for(a)), s)
    s2, _ = read_sharded_restart(str(tmp_path / "ckpt"), cfg,
                                 shardings=shardings)
    assert s2.tracer_cur.sharding.mesh.shape == {"y": 2, "x": 2}
    np.testing.assert_array_equal(np.asarray(s.tracer_cur),
                                  np.asarray(s2.tracer_cur))


_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import numpy as np
from pop2_tpu.parallel import multihost
multihost.initialize_distributed(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()
mesh = multihost.global_mesh((2, 2))  # 2 procs x 2 local devices
ny, nx = 8, 8
rows = ny // nproc
local = np.full((rows, nx), float(pid))
garr = multihost.make_global_array(local, mesh, P("y", "x"))
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(garr)
expect = sum(p * rows * nx for p in range(nproc))
assert float(total) == expect, (float(total), expect)
print("OK", pid)
"""


@pytest.mark.slow
def test_two_process_distributed_smoke(tmp_path):
    """Launch 2 JAX processes on CPU, initialize the distributed runtime,
    build a global mesh spanning both, and reduce over a globally-assembled
    array — the multi-host bring-up path end to end."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = "12473"
    env = dict(os.environ)
    # the workers import pop2_tpu from the repo root, not from an install
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"OK {pid}" in out
