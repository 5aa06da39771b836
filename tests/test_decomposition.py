"""Decomposition invariance of the plain tendency functions: each stencil
chain evaluated on y- and x-sharded meshes of virtual CPU devices must match
the single-device result (the reference's b4b-across-decompositions
requirement, SURVEY.md §4.3). These are the tracer-advection/diffusion, GM
and anisotropic-viscosity chains XLA partitions on its own, halo exchanges
included."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pop2_tpu import advect, eos, gm, hmix, submeso
from pop2_tpu.config import get_config
from pop2_tpu.grid import build_grid, grid_bc
from pop2_tpu.parallel import mesh as pmesh

_GM = dict(hmix_tracer="gm", gm_kappa_isop_type="bfre",
           gm_kappa_thic_type="bfre", gm_transition_layer=True,
           ns_boundary="tripole", vert_grid="uniform")

CASES = {
    "del2_centered_closed": dict(),
    "upwind3_closed": dict(tadvect="upwind3"),
    "del2_centered_tripole": dict(ns_boundary="tripole"),
    "upwind3_tripole": dict(tadvect="upwind3", ns_boundary="tripole"),
    "gm": dict(_GM),
    "gm_submeso": dict(_GM, lsubmeso=True),
    "aniso_tripole": dict(hmix_momentum="aniso", aniso_alignment="east",
                          ns_boundary="tripole"),
}


@functools.lru_cache(maxsize=None)
def _setup(case):
    cfg = get_config("mini").with_(**CASES[case])
    grid = build_grid(cfg)
    km, ny, nx = cfg.km, cfg.ny, cfg.nx
    rng = np.random.RandomState(5)
    mask = np.asarray(grid.kmask_t)
    zt = np.asarray(grid.vgrid.zt)
    lat = np.asarray(grid.TLAT)
    T = ((2.0 + 16.0 * np.exp(-zt / 8.0e4))[:, None, None]
         + 1.5 * np.cos(2 * lat)[None] + 0.1 * rng.randn(km, ny, nx)) * mask
    S = (0.0347 + 5.0e-5 * np.sin(3 * lat)[None]
         + 2.0e-5 * rng.randn(km, ny, nx)) * mask
    trcr = np.stack([T, S])
    umask = np.asarray(grid.kmask_u)
    u = 10.0 * rng.randn(km, ny, nx) * umask
    v = 10.0 * rng.randn(km, ny, nx) * umask
    dh = 1.0e-4 * rng.randn(ny, nx)
    depth = 4.0e3 + 1.0e3 * rng.rand(ny, nx)    # hblt / hmxl, cm
    args = tuple(jnp.asarray(a) for a in (trcr, u, v, dh, depth))
    return cfg, grid, args


def _tendencies(cfg, ts_range, grid, trcr, u, v, dh, depth):
    bc = grid_bc(cfg)
    if cfg.hmix_tracer == "gm":
        out = gm.hdifft_gm(cfg, grid, bc, ts_range, trcr, hblt=depth)
        ft = out.gtk
        if cfg.lsubmeso:
            ft = ft + submeso.submeso_tendency(cfg, grid, bc, ts_range,
                                               trcr, hmxl=depth)[0]
        return ft, out.vdc_gm
    if cfg.hmix_momentum == "aniso":
        return hmix.hdiffu(cfg, grid, bc, u, v)
    fv = advect.comp_flux_vel(cfg, grid, bc, u, v, dh)
    return (hmix.hdifft(cfg, grid, bc, trcr),
            advect.advt(cfg, grid, bc, fv, trcr))


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tendency_invariant_under_sharding(case, mesh_shape, cpu_devices8):
    cfg, grid, args = _setup(case)
    ts_range = eos.build_ts_range(np.asarray(grid.vgrid.zt), cfg.jnp_dtype)
    # the grid is closed over, as in Model's jitted step (init-time host
    # reads of it must see concrete values)
    want = jax.jit(functools.partial(_tendencies, cfg, ts_range, grid))(
        *args)

    mesh = pmesh.make_mesh(mesh_shape, cpu_devices8)
    got = jax.jit(functools.partial(
        _tendencies, cfg, ts_range, pmesh.shard_pytree(grid, mesh)))(
        *pmesh.shard_pytree(args, mesh))
    assert not got[0].sharding.is_fully_replicated
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(w).all() and np.abs(w).max() > 0
        # XLA compiles each partitioned program's fusions separately, so
        # sharded and single-device results agree to rounding, not bitwise
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-11 * np.abs(w).max())
