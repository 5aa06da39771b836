"""Model prognostic state and initialization.

Reference: ``source/prognostic.F90`` — the 3-time-level rotating-index arrays
become an immutable two-level (old, cur) pytree carried through the functional
step; the ``newtime`` slot exists only as intermediate values inside ``step``
(the index rotation at source/step_mod.F90:827-831 becomes pytree
reassignment).

Initialization 'internal' reproduces the reference's horizontally-uniform 1992
Levitus T/S profile (source/initial.F90:962-1428).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from pop2_tpu import pytree

from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid
from pop2_tpu import eos


@pytree.dataclass
class State:
    """Two-time-level prognostic state (shapes: tracer (nt,km,ny,nx),
    velocity/rho (km,ny,nx), 2-D fields (ny,nx))."""
    tracer_old: jnp.ndarray
    tracer_cur: jnp.ndarray
    u_old: jnp.ndarray
    u_cur: jnp.ndarray
    v_old: jnp.ndarray
    v_cur: jnp.ndarray
    rho_old: jnp.ndarray
    rho_cur: jnp.ndarray
    ubtrop_old: jnp.ndarray
    ubtrop_cur: jnp.ndarray
    vbtrop_old: jnp.ndarray
    vbtrop_cur: jnp.ndarray
    psurf_old: jnp.ndarray
    psurf_cur: jnp.ndarray
    gradpx_old: jnp.ndarray
    gradpx_cur: jnp.ndarray
    gradpy_old: jnp.ndarray
    gradpy_cur: jnp.ndarray
    pguess: jnp.ndarray
    fw_old: jnp.ndarray
    qice: jnp.ndarray
    aqice: jnp.ndarray
    # Robert-filter conservation memory (source/step_mod.F90:1329-1350)
    rf_s_prev: jnp.ndarray        # (nt,) previous-step <S> per tracer
    rf_s_prev_valid: jnp.ndarray  # () 1.0 once rf_s_prev holds real data


# 1992 Levitus global-mean profiles (source/initial.F90:963-1003)
DEPTH_LEVITUS = np.array([
    0., 10., 20., 30., 50., 75., 100., 125., 150., 200., 250., 300., 400.,
    500., 600., 700., 800., 900., 1000., 1100., 1200., 1300., 1400., 1500.,
    1750., 2000., 2500., 3000., 3500., 4000., 4500., 5000., 5500.])
TMEAN_LEVITUS = np.array([
    18.27, 18.22, 18.09, 17.87, 17.17, 16.11, 15.07, 14.12, 13.29, 11.87,
    10.78, 9.94, 8.53, 7.35, 6.38, 5.65, 5.06, 4.57, 4.13, 3.80, 3.51, 3.26,
    3.05, 2.86, 2.47, 2.19, 1.78, 1.49, 1.26, 1.05, 0.91, 0.87, 1.00])
SMEAN_LEVITUS = np.array([
    34.57, 34.67, 34.73, 34.79, 34.89, 34.97, 35.01, 35.03, 35.03, 34.98,
    34.92, 34.86, 34.76, 34.68, 34.63, 34.60, 34.59, 34.60, 34.61, 34.63,
    34.65, 34.66, 34.68, 34.70, 34.72, 34.74, 34.75, 34.74, 34.74, 34.73,
    34.73, 34.72, 34.72])


def levitus_profile(zt_cm: np.ndarray):
    """Piecewise-linear interpolation of the Levitus mean profile to layer
    midpoints (source/initial.F90:1397-1416)."""
    z_m = np.asarray(zt_cm) * const.MPERCM
    t = np.interp(z_m, DEPTH_LEVITUS, TMEAN_LEVITUS)
    s = np.interp(z_m, DEPTH_LEVITUS, SMEAN_LEVITUS) * const.PPT_TO_SALT
    return t, s


def initial_state(cfg: ModelConfig, grid: Grid, passive=None) -> State:
    """Rest state with the internal Levitus T/S profile; passive-tracer
    packages supply their own initial fields for slots 2.."""
    dt = cfg.jnp_dtype
    nt, km, ny, nx = cfg.nt, cfg.km, cfg.ny, cfg.nx
    tinit, sinit = levitus_profile(np.asarray(grid.vgrid.zt))
    tracer = np.zeros((nt, km, ny, nx))
    kmask = np.asarray(grid.kmask_t)
    tracer[0] = tinit[:, None, None] * kmask
    tracer[1] = sinit[:, None, None] * kmask
    if passive is not None and passive.packages:
        tracer[2:] = passive.init_values(cfg, grid) * kmask[None]
    tracer_j = jnp.asarray(tracer, dt)

    rho = eos.state(cfg, grid.vgrid.pressz, tracer_j[0], tracer_j[1])
    rho = jnp.where(grid.kmask_t, rho, 0.0)

    z2 = jnp.zeros((ny, nx), dt)
    z3 = jnp.zeros((km, ny, nx), dt)
    return State(
        tracer_old=tracer_j, tracer_cur=tracer_j,
        u_old=z3, u_cur=z3, v_old=z3, v_cur=z3,
        rho_old=rho, rho_cur=rho,
        ubtrop_old=z2, ubtrop_cur=z2, vbtrop_old=z2, vbtrop_cur=z2,
        psurf_old=z2, psurf_cur=z2,
        gradpx_old=z2, gradpx_cur=z2, gradpy_old=z2, gradpy_cur=z2,
        pguess=z2, fw_old=z2, qice=z2, aqice=z2,
        rf_s_prev=jnp.zeros((nt,), dt),
        rf_s_prev_valid=jnp.zeros((), dt))
