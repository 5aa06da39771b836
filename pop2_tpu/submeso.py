"""Submesoscale mixed-layer eddy parameterization (Fox-Kemper et al.).

Reference: ``source/mix_submeso.F90`` — an overturning streamfunction
Psi ~ Ce H^2 mu(z) (grad_H b)_ML / |f| restratifies the mixed layer;
implemented as a skew flux with the same quarter-cell structure as GM
(submeso_sf :341-772, submeso_flux :779-1008). Density/tracer face
differences are shared with GM (hmix_gm_submeso_share.F90).

The streamfunction is a dense (2 faces, 2 halves, km, ny, nx)
array produced in one batched pass (the reference's CONTINUE_INTEGRAL
masked k loops become closed-form weight vectors), and the flux divergence
reuses the skew-flux assembly style of ``gm.py``.
"""

from __future__ import annotations

import jax.numpy as jnp

from pop2_tpu import constants as const
from pop2_tpu import gm as gm_mod
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid
from pop2_tpu.stencil import BC


def _ml_layer_weights(grid, ml):
    """Thickness of each layer inside the mixed layer: dz(k) for fully
    contained layers, ml - zw(k-1) for the layer containing the base
    (submeso_sf :435-466)."""
    km = grid.vgrid.dz.shape[0]
    zw = grid.vgrid.zw
    zw_top = jnp.concatenate([jnp.zeros_like(zw[:1]), zw[:-1]])
    zwk = zw[:, None, None]
    zwt = zw_top[:, None, None]
    dz = grid.vgrid.dz[:, None, None]
    full = ml[None] > zwk
    partial = (ml[None] <= zwk) & (ml[None] > zwt)
    return jnp.where(full, dz, jnp.where(partial, ml[None] - zwt, 0.0))


def streamfunction(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                   hmxl=None):
    """SF_SUBM_X/Y, shape (2 faces, 2 halves, km, ny, nx), and the
    horizontal length scale HLS (submeso_sf :341-772)."""
    km = cfg.km
    zt = grid.vgrid.zt
    zw = grid.vgrid.zw
    dz = grid.vgrid.dz
    dzw = grid.vgrid.dzw
    ocean = grid.KMT > 0

    ml = hmxl if hmxl is not None else jnp.full_like(grid.HT, zw[0])
    ml = jnp.where(ocean, jnp.maximum(ml, zw[0]), zw[0])

    # only the T/S density diffs are needed for the buoyancy
    # gradients: slice to two tracers (rx/ry/rz depend on T,S alone)
    _, _, _, rx, ry, rz_ktp_raw, _ = gm_mod.face_density_diffs(
        cfg, grid, bc, ts_range, tmix[:2])
    rz_save = jnp.minimum(rz_ktp_raw, 0.0)   # RZ_SAVE (share module :398)

    # mixed-layer vertical average of the horizontal buoyancy gradient
    w = _ml_layer_weights(grid, ml)
    bx = -const.GRAV * jnp.sum(rx * w[None], axis=1) / ml[None]
    by = -const.GRAV * jnp.sum(ry * w[None], axis=1) / ml[None]
    bx = jnp.where(ocean[None], bx, 0.0)
    by = jnp.where(ocean[None], by, 0.0)

    # time scale 1/sqrt(f^2 + 1/tau^2) (init_submeso :267-269)
    ts = 1.0 / jnp.sqrt(grid.FCORT ** 2
                        + 1.0 / cfg.submeso_timescale ** 2)

    if cfg.submeso_const_hls:
        hls = jnp.where(ocean, cfg.submeso_hor_length_scale, 0.0)
    else:
        # deformation-radius-like scales (submeso_sf :483-546)
        w1 = jnp.sqrt(0.5 * ((bx[0] ** 2 + bx[1] ** 2) / grid.DXT ** 2
                             + (by[0] ** 2 + by[1] ** 2) / grid.DYT ** 2))
        w1 = w1 * ml * ts ** 2
        # integral of N through the mixed layer: for k=2..km weight
        # dzw(k-1) while ml > zt(k), quadratic partial weight in the layer
        # containing the base
        ztk = zt[1:, None, None]          # zt(k), k = 2..km
        ztkm1 = zt[:-1, None, None]
        dzwk = dzw[1:km, None, None]      # dzw(k-1)
        full = ml[None] > ztk
        partial = (ml[None] <= ztk) & (ml[None] >= ztkm1)
        w3 = jnp.where(full, dzwk,
                       jnp.where(partial,
                                 (ml[None] - ztkm1) ** 2 / dzwk, 0.0))
        w2 = jnp.sum(jnp.sqrt(jnp.maximum(-rz_save[1:] * w3, 0.0)), axis=0)
        w2 = jnp.sqrt(const.GRAV) * w2 * ts
        hls = jnp.where(ocean,
                        jnp.maximum(jnp.maximum(w1, w2),
                                    cfg.submeso_hor_length_scale), 0.0)

    # streamfunction per quarter cell (submeso_sf :551-596):
    # Psi = Ce ml^2 mu(z) T / HLS * grad_b, mu the Fox-Kemper vertical shape
    kidx = jnp.arange(1, km + 1)[:, None, None]
    in_col = kidx <= grid.KMT[None]
    ref_depth = jnp.stack([zt - 0.25 * dz, zt + 0.25 * dz])  # (2 halves, km)
    rd = ref_depth[:, :, None, None]
    active = (rd < ml[None, None]) & in_col[None]
    w3 = (1.0 - 2.0 * rd / ml[None, None]) ** 2
    mu = (1.0 - w3) * (1.0 + (5.0 / 21.0) * w3)
    hls_safe = jnp.where(hls > 0.0, hls, 1.0)
    amp = jnp.where(active,
                    cfg.submeso_efficiency * ml[None, None] ** 2 * mu
                    * ts[None, None] / hls_safe[None, None], 0.0)
    cdx = jnp.minimum(grid.DXT, cfg.submeso_max_grid_scale)
    cdy = jnp.minimum(grid.DYT, cfg.submeso_max_grid_scale)
    # (face, half, km, ny, nx)
    sfx = amp[None] * bx[:, None, None] * cdx
    sfy = amp[None] * by[:, None, None] * cdy
    return sfx, sfy, hls


def gtk(cfg: ModelConfig, grid: Grid, bc: BC, sfx, sfy, tmix, tx, ty, tz):
    """Skew-flux divergence of the submeso streamfunction for all tracers
    (submeso_flux :779-1008). Returns (nt, km, ny, nx)."""
    km = cfg.km
    kidx = jnp.arange(1, km + 1)[:, None, None]
    # HYX = HTE/HUS, HXY = HTN/HUW (source/grid.F90 stencil metrics)
    hyx = grid.HTE / grid.HUS
    hxy = grid.HTN / grid.HUW
    cx = jnp.where((kidx <= grid.KMT[None]) & (kidx <= grid.KMTE[None]),
                   0.25 * hyx, 0.0)
    cy = jnp.where((kidx <= grid.KMT[None]) & (kidx <= grid.KMTN[None]),
                   0.25 * hxy, 0.0)
    km_mask = (kidx < grid.KMT[None]).astype(cx.dtype)

    tz_kp1 = jnp.concatenate([tz[:, 1:], tz[:, -1:]], axis=1)
    tx_kp1 = jnp.concatenate([tx[:, 1:], tx[:, -1:]], axis=1)
    ty_kp1 = jnp.concatenate([ty[:, 1:], ty[:, -1:]], axis=1)

    fx = cx[None] * (sfx[0, 0][None] * tz + sfx[0, 1][None] * tz_kp1
                     + bc.e(sfx[1, 0])[None] * bc.e(tz)
                     + bc.e(sfx[1, 1])[None] * bc.e(tz_kp1))
    fy = cy[None] * (sfy[0, 0][None] * tz + sfy[0, 1][None] * tz_kp1
                     + bc.n_partner(sfy[1, 0], sfy[0, 0],
                                    "center", "vector")[None] * bc.n(tz)
                     + bc.n_partner(sfy[1, 1], sfy[0, 1],
                                    "center", "vector")[None]
                     * bc.n(tz_kp1))

    hyxw = bc.w(hyx)
    hxys = bc.s(hxy)
    sfx_ktp_kp1 = jnp.concatenate([sfx[:, 0, 1:],
                                   jnp.zeros_like(sfx[:, 0, :1])], axis=1)
    sfy_ktp_kp1 = jnp.concatenate([sfy[:, 0, 1:],
                                   jnp.zeros_like(sfy[:, 0, :1])], axis=1)

    def cross(sl_x, sl_y, txl, tyl):
        return (sl_x[0] * hyx * txl + sl_y[0] * hxy * tyl
                + sl_x[1] * hyxw * bc.w(txl) + sl_y[1] * hxys * bc.s(tyl))

    work = (cross(sfx[:, 1], sfy[:, 1], tx, ty)
            + cross(sfx_ktp_kp1, sfy_ktp_kp1, tx_kp1, ty_kp1))
    fz = -km_mask[None] * 0.25 * work
    fz = fz.at[:, -1].set(0.0)
    fz_top = jnp.concatenate([jnp.zeros_like(fz[:, :1]), fz[:, :-1]], axis=1)

    out = ((fx - bc.w(fx) + fy - bc.s(fy) + fz_top - fz)
           * grid.vgrid.dzr[None, :, None, None] * grid.TAREA_R)
    return jnp.where(grid.kmask_t[None], out, 0.0)


def submeso_tendency(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                     hmxl=None):
    """Full submesoscale tracer tendency (streamfunction + flux)."""
    sfx, sfy, hls = streamfunction(cfg, grid, bc, ts_range, tmix, hmxl)
    tx, ty, tz, _, _, _, _ = gm_mod.face_density_diffs(
        cfg, grid, bc, ts_range, tmix)
    return gtk(cfg, grid, bc, sfx, sfy, tmix, tx, ty, tz), hls
