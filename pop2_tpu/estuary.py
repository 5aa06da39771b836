"""Estuary virtual-salt-flux parameterization (river runoff).

Reference: ``source/estuary_vsf_mod.F90`` — with ``lvsf_river`` the virtual
salt flux of river runoff uses the LOCAL surface salinity instead of the
constant reference salinity, plus a globally-uniform correction so the
global salt budget matches the reference-salinity formulation
(set_estuary_vsf_forcing; vsf_river_correction). The estuary box model
(EBM exchange circulation, set_estuary_exch_circ) requires estuary
geometry datasets and is not rebuilt.
"""

from __future__ import annotations

import jax.numpy as jnp

from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid


def river_vsf(cfg: ModelConfig, grid: Grid, roff_f, s_surface):
    """Virtual salt flux of river water using local salinity.

    roff_f: (ny, nx) river runoff (kg freshwater/m^2/s, positive into
    ocean); s_surface: (ny, nx) model surface salinity (msu).
    Returns the STF_S contribution (msu cm/s): local-salinity flux plus
    the uniform correction term (estuary_vsf_mod.F90
    set_estuary_vsf_forcing).
    """
    r = grid.RCALCT
    # local-salinity virtual salt flux: fresh water dilutes at S_local
    flux_loc = -roff_f * const.FWFLUX_FACTOR_SALT * s_surface \
        * const.SALT_TO_PPT * r
    # reference-salinity flux (the standard salinity_factor form)
    flux_ref = roff_f * const.SALINITY_FACTOR * r
    area = grid.area_t
    from pop2_tpu.reductions import global_sum
    correction = global_sum((flux_ref - flux_loc) * grid.TAREA * r,
                            b4b=cfg.b4b) / area
    return flux_loc + correction * r


# ---------------------------------------------------------------------------
# Estuary box model (EBM) exchange circulation
# (estuary_box_model, source/estuary_vsf_mod.F90:979-1187;
#  set_estuary_exch_circ :645-755)
# ---------------------------------------------------------------------------

BETA_S = 7.7e-4     # saline contraction (1/ppt) (:1081)
SCHMIDT_EBM = 2.2   # estuarine Schmidt number (:1082)


def _cubic_neg_real_root(b, c, d):
    """Vectorized real roots of x^3 + b x^2 + c x + d = 0, returning the
    (physically unique) negative real root, 0 where none exists — the
    vectorized replacement for the reference's cubsolve + root scan
    (:1112-1131). Uses the trigonometric method for three real roots and
    Cardano for one."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    shift = -b / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3

    # three-real-roots branch (disc <= 0): t_k = 2 sqrt(-p/3) cos(...)
    pm = jnp.minimum(p, -1.0e-30)
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    theta = jnp.arccos(arg) / 3.0
    two_pi_3 = 2.0 * jnp.pi / 3.0
    roots3 = [m * jnp.cos(theta - k * two_pi_3) + shift for k in range(3)]

    # single-real-root branch (disc > 0): Cardano
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    root1 = u + v + shift

    out = jnp.zeros_like(b)
    for r in roots3:
        cand = jnp.where((disc <= 0.0) & (r < 0.0), r, 0.0)
        out = jnp.where(out == 0.0, cand, out)  # first negative real root
    out = jnp.where((disc > 0.0) & (root1 < 0.0), root1, out)
    return out


def ebm_solve(q_river, tide_amp, s_lower, w_h, h, a1, a2, h0):
    """Vectorized estuary box model (Sun et al. 2017 EBMv2.4;
    estuary_box_model :979-1187). All inputs broadcastable 2-D fields in
    MKS/ppt like the reference's scalars: q_river m^3/s, tide_amp m,
    s_lower ppt, w_h/h m. Returns (q_upper, q_lower, s_upper):
    m^3/s, m^3/s (negative = inflow at depth), ppt."""
    g = const.GRAV / 100.0
    active = (s_lower > 0.0) & (q_river > 0.0)
    s_l = jnp.maximum(s_lower, 1.0e-3)
    qr = jnp.maximum(q_river, 1.0e-6)

    u_t = -tide_amp * jnp.sqrt(g / h)
    u_r = qr / (w_h * h * (1.0 - h0))
    c_wave = jnp.sqrt(BETA_S * s_l * g * h)
    ur0 = u_r / c_wave
    ut0 = u_t / c_wave
    r0 = ur0 * (1.0 - h0)
    t0 = ut0 * (1.0 - h0) / jnp.pi

    mix = (SCHMIDT_EBM ** 2 * r0) ** (-1.0 / 3.0)
    a = -h0 ** 3
    b = 2.0 * h0 ** 2 * ((2.0 - h0) * r0 - a2 * t0)
    c = (0.096 * a1 * h0 * mix * r0
         - h0 * ((2.0 - h0) * r0 * (r0 - 2.0 * a2 * t0)
                 + a2 ** 2 * t0 ** 2))
    d = -0.048 * a1 * mix * r0 * (r0 - 2.0 * a2 * t0)

    ul0 = _cubic_neg_real_root(b / a, c / a, d / a)
    uu0 = r0 / (1.0 - h0) - h0 / (1.0 - h0) * ul0
    q_l = ul0 * h0 * h * w_h * c_wave
    q_u = uu0 * (1.0 - h0) * h * w_h * c_wave
    s_u = jnp.where(q_u != 0.0, -q_l * s_l / jnp.where(q_u != 0.0, q_u, 1.0),
                    0.0)
    zero = jnp.zeros_like(q_u)
    return (jnp.where(active, q_u, jnp.where(q_river > 0.0, q_river, 0.0)),
            jnp.where(active, q_l, zero),
            jnp.where(active, s_u, zero))


def exchange_layer_weights(cfg: ModelConfig, grid: Grid,
                           h_upper_cm: float, h_lower_cm: float):
    """Static per-level overlap weights of the EBM upper/lower layers with
    the model levels (set_estuary_exch_circ :676-706). Returns
    (w_up, w_lo), each (km,) summing to 1 over the layer."""
    import numpy as np
    km = cfg.km
    zw = np.asarray(grid.vgrid.zw)
    ztop = np.concatenate([[0.0], zw[:-1]])
    z1 = h_upper_cm
    z2 = h_upper_cm + h_lower_cm
    w_up = np.clip(np.minimum(zw, z1) - ztop, 0.0, None) / z1
    w_lo = np.clip(np.minimum(zw, z2) - np.maximum(ztop, z1), 0.0,
                   None) / h_lower_cm
    return w_up, w_lo


def exchange_circulation(cfg: ModelConfig, grid: Grid, tracer_cur, roff_f,
                         w_up, w_lo, want_flux: bool = False):
    """Tracer tendency of the EBM exchange circulation (nt, km, ny, nx):
    Q_lower draws lower-layer ocean water into the estuary and Q_upper
    returns it mixed with river water — a vertical redistribution with flux
    FLUX_EXCH_INTRF = -Q_l (T_lower - T_upper_out) / TAREA across the layer
    interface (:727-738), applied conservatively: source in the upper
    layer, sink in the lower layer.

    roff_f: (ny, nx) river runoff (kg/m^2/s); w_up/w_lo: (km,) from
    exchange_layer_weights.
    """
    km = cfg.km
    w_up_j = jnp.reshape(jnp.asarray(w_up, tracer_cur.dtype), (km, 1, 1))
    w_lo_j = jnp.reshape(jnp.asarray(w_lo, tracer_cur.dtype), (km, 1, 1))

    # layer-average tracers (ppt handled internally in msu — unit factors
    # cancel in the difference/redistribution)
    t_up = jnp.sum(tracer_cur * w_up_j[None], axis=1)
    t_lo = jnp.sum(tracer_cur * w_lo_j[None], axis=1)

    # EBM per point, MKS: Q_river m^3/s from kg/m^2/s runoff over the cell
    # (:663: fwmass_to_fwflux*ROFF_F*TAREA*1e-6)
    q_river = roff_f * const.FWMASS_TO_FWFLUX * grid.TAREA * 1.0e-6
    s_lower_ppt = t_lo[1] * const.SALT_TO_PPT
    q_u, q_l, s_u = ebm_solve(
        q_river, jnp.asarray(cfg.est_tide_amp), s_lower_ppt,
        jnp.asarray(cfg.est_mouth_width), jnp.asarray(cfg.est_mouth_depth),
        jnp.asarray(cfg.est_length_a1), jnp.asarray(cfg.est_tidal_pump_a2),
        jnp.asarray(cfg.est_lower_depth_ratio))

    # upper-layer outflow tracer: salinity from the EBM, others unchanged
    t_out = t_up.at[1].set(s_u * const.PPT_TO_SALT)

    # interface flux, tracer * cm/s (:733-738); Q_l < 0 so flux > 0 moves
    # tracer upward (lower -> upper)
    flux = -q_l[None] * 1.0e6 * (t_lo - t_out) * grid.TAREA_R * grid.RCALCT

    # conservative redistribution: gain spread over the upper layer, loss
    # over the lower layer (column integral of src vanishes)
    dz3 = jnp.reshape(grid.vgrid.dz, (km, 1, 1))
    h_up_cm = jnp.sum(w_up_j * dz3, axis=0)
    h_lo_cm = jnp.sum(w_lo_j * dz3, axis=0)
    src = flux[:, None] * (w_up_j[None] / jnp.maximum(h_up_cm, 1.0)
                           - w_lo_j[None] / jnp.maximum(h_lo_cm, 1.0))
    src = jnp.where(grid.kmask_t[None], src, 0.0)
    if want_flux:
        # (src, FLUX_EXCH_INTRF) — the interface flux is the
        # T/S_FLUX_EXCH_INTRF tavg field (estuary_vsf_mod.F90:740-751)
        return src, flux
    return src
