"""Decomposition invariance: the same steps on a sharded mesh must match the
single-device run (the reference's b4b-across-decompositions requirement,
SURVEY.md §4.3; tested on the 8-device virtual CPU mesh from conftest)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from pop2_tpu.config import get_config
from pop2_tpu.model import Model
from pop2_tpu.parallel import mesh as pmesh


def test_sharded_matches_single_device(cpu_devices8):
    cfg = get_config("mini")
    m1 = Model(cfg)
    st1 = m1.initial_state()
    for _ in range(5):
        st1, _ = m1.advance(st1)

    cfg8 = cfg.with_(mesh_shape=(4, 2))
    m8, mesh = pmesh.sharded_model(cfg8)
    st8 = pmesh.shard_pytree(m8.initial_state(), mesh)
    for _ in range(5):
        st8, _ = m8.advance(st8)

    np.testing.assert_allclose(np.asarray(st1.tracer_cur),
                               np.asarray(st8.tracer_cur),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(st1.u_cur), np.asarray(st8.u_cur),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(st1.psurf_cur),
                               np.asarray(st8.psurf_cur),
                               rtol=0, atol=1e-9)


def test_sharded_with_pallas_tridiag_matches_single_device(mini_grid,
                                                           cpu_devices8):
    """The Thomas kernel (interpret mode) dispatched per shard through
    ``jax.shard_map`` under a (2, 2) mesh matches the unsharded kernel:
    columns are independent, so the sharded solve needs no communication."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from pop2_tpu import tridiag_pallas

    grid = mini_grid
    km = grid.kmask_t.shape[0]
    ny, nx = grid.KMT.shape
    rng = np.random.RandomState(3)
    hfac = jnp.asarray(rng.uniform(0.1, 1.0, km))
    h1 = hfac[0] + jnp.asarray(rng.uniform(0.0, 0.1, (ny, nx)))
    a = jnp.asarray(rng.uniform(0.0, 2.0, (km, ny, nx))).at[-1].set(0.0)
    rhs = jnp.asarray(rng.randn(2, km, ny, nx))
    args = (hfac, h1, grid.KMT, a, rhs)
    want = tridiag_pallas.thomas(*args, interpret=True)

    mesh = pmesh.make_mesh((2, 2), cpu_devices8)
    sharded = pmesh.shard_pytree(args, mesh)
    with tridiag_pallas.dispatch_mesh(mesh):
        got = jax.jit(functools.partial(tridiag_pallas.thomas,
                                        interpret=True))(*sharded)
    assert got.sharding.is_equivalent_to(
        NamedSharding(mesh, P(None, None, "y", "x")), got.ndim)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_sharded_output_is_sharded(cpu_devices8):
    cfg = get_config("mini").with_(mesh_shape=(2, 4))
    m8, mesh = pmesh.sharded_model(cfg)
    st = pmesh.shard_pytree(m8.initial_state(), mesh)
    st, _ = m8.advance(st)
    sh = st.tracer_cur.sharding
    assert sh.is_fully_replicated is False
