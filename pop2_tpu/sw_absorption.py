"""Penetrating shortwave absorption.

Reference: ``source/sw_absorption.F90`` — Jerlov water-type double-exponential
transmission (:786-805), per-level absorption profile (:364-369), tracer
source ``add_sw_absorb`` (:818-905), and the chlorophyll-dependent variant
(Ohlmann 2003 Table 1a coefficients :135-217; transmission
Trans(z) = A1 exp(-B1 z) + A2 exp(-B2 z) built as a 400-entry log-chl lookup
table :640-718). Instead of the lookup table the A/B coefficients
are interpolated in log-chl directly on the (ny, nx) chlorophyll field and
the transmission evaluated in closed form — pure elementwise math XLA fuses
into the tracer update.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid

# Jerlov water types I, IA, IB, II, III (source/sw_absorption.F90:786-788)
RFAC = np.array([0.58, 0.62, 0.67, 0.77, 0.78])
DEPTH1 = np.array([0.35, 0.60, 1.00, 1.50, 1.40])
DEPTH2 = np.array([23.0, 20.0, 17.0, 14.0, 7.90])
DEPTH_CUTOFF = -200.0  # meters


def sw_absorb_frac(depth_cm, water_type: int):
    """Transmission fraction at depth (source/sw_absorption.F90:796-805)."""
    i = water_type - 1
    z = -np.asarray(depth_cm) * const.MPERCM
    frac = (RFAC[i] * np.exp(z / DEPTH1[i])
            + (1.0 - RFAC[i]) * np.exp(z / DEPTH2[i]))
    return np.where(z < DEPTH_CUTOFF, 0.0, frac)


def sw_absorb_frac_jnp(depth_cm, water_type: int):
    """Traced (jnp) variant of :func:`sw_absorb_frac` for depths computed
    inside jit (KPP's lshort_wave radiative bldepth contribution,
    source/vmix_kpp.F90:2387-2402, 2715-2720)."""
    i = water_type - 1
    z = -depth_cm * const.MPERCM
    frac = (RFAC[i] * jnp.exp(z / DEPTH1[i])
            + (1.0 - RFAC[i]) * jnp.exp(z / DEPTH2[i]))
    return jnp.where(z < DEPTH_CUTOFF, 0.0, frac)


def absorb_profile(cfg: ModelConfig, grid: Grid) -> jnp.ndarray:
    """Per-interface transmission sw_absorb(0:km)
    (source/sw_absorption.F90:364-369): 1 at the surface, 0 below km."""
    km = cfg.km
    zw = np.asarray(grid.vgrid.zw)
    prof = np.zeros(km + 1)
    prof[0] = 1.0
    prof[1:km] = sw_absorb_frac(zw[:km - 1], cfg.jerlov_water_type)
    prof[km] = 0.0
    return jnp.asarray(prof, cfg.jnp_dtype)


def add_sw_absorb(cfg: ModelConfig, grid: Grid, ft, shf_qsw, sw_absorb):
    """Add penetrative shortwave heating to the temperature tendency
    (source/sw_absorption.F90:875-898): in the interior the layer absorbs
    the transmission difference; at the local bottom it absorbs everything
    that reached it (no energy into the ground). ``sw_absorb`` is the
    per-interface transmission: (km+1,) for the static Jerlov profile or
    (km+1, ny, nx) for the chlorophyll-dependent one."""
    km = cfg.km
    work = jnp.maximum(shf_qsw, 0.0)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    dzr = jnp.reshape(grid.vgrid.dzr, (km, 1, 1))
    if sw_absorb.ndim == 1:
        sw_absorb = jnp.reshape(sw_absorb, (km + 1, 1, 1))
    frac_interior = sw_absorb[:-1] - sw_absorb[1:]
    frac_bottom = sw_absorb[:-1]
    frac = jnp.where(kidx < grid.KMT[None], frac_interior, frac_bottom)
    src = jnp.where(kidx <= grid.KMT[None], work[None] * frac * dzr, 0.0)
    return ft.at[0].add(src)


# -- chlorophyll-dependent transmission (Ohlmann 2003, Table 1a;
#    source/sw_absorption.F90:135-217) ---------------------------------------

CHLCNC = np.array([
    0.001, 0.005, 0.01, 0.02, 0.03, 0.05, 0.10, 0.15, 0.20, 0.25, 0.30,
    0.35, 0.40, 0.45, 0.50, 0.60, 0.70, 0.80, 0.90, 1.00, 1.50, 2.00,
    2.50, 3.00, 4.00, 5.00, 6.00, 7.00, 8.00, 9.00, 10.00])
A_1 = np.array([
    0.4421, 0.4451, 0.4488, 0.4563, 0.4622, 0.4715, 0.4877, 0.4993,
    0.5084, 0.5159, 0.5223, 0.5278, 0.5326, 0.5369, 0.5408, 0.5474,
    0.5529, 0.5576, 0.5615, 0.5649, 0.5757, 0.5802, 0.5808, 0.5788,
    0.56965, 0.55638, 0.54091, 0.52442, 0.50766, 0.49110, 0.47505])
A_2 = np.array([
    0.2981, 0.2963, 0.2940, 0.2894, 0.2858, 0.2800, 0.2703, 0.2628,
    0.2571, 0.2523, 0.2481, 0.2444, 0.2411, 0.2382, 0.2356, 0.2309,
    0.2269, 0.2235, 0.2206, 0.2181, 0.2106, 0.2089, 0.2113, 0.2167,
    0.23357, 0.25504, 0.27829, 0.30274, 0.32698, 0.35056, 0.37303])
B_1 = np.array([
    0.0287, 0.0301, 0.0319, 0.0355, 0.0384, 0.0434, 0.0532, 0.0612,
    0.0681, 0.0743, 0.0800, 0.0853, 0.0902, 0.0949, 0.0993, 0.1077,
    0.1154, 0.1227, 0.1294, 0.1359, 0.1640, 0.1876, 0.2082, 0.2264,
    0.25808, 0.28498, 0.30844, 0.32932, 0.34817, 0.36540, 0.38132])
B_2 = np.array([
    0.3192, 0.3243, 0.3306, 0.3433, 0.3537, 0.3705, 0.4031, 0.4262,
    0.4456, 0.4621, 0.4763, 0.4889, 0.4999, 0.5100, 0.5191, 0.5347,
    0.5477, 0.5588, 0.5682, 0.5764, 0.6042, 0.6206, 0.6324, 0.6425,
    0.66172, 0.68144, 0.70086, 0.72144, 0.74178, 0.76190, 0.78155])

MAXARG = 35.0  # exp-underflow guard (source/sw_absorption.F90:703)


def chl_coeffs(chl):
    """Interpolated Ohlmann (2003) double-exponential coefficients for a
    surface chlorophyll field (sw_absorption.F90:640-718)."""
    # float() so the np.float64 table bounds don't promote fp32 fields
    logc = jnp.log(jnp.clip(chl, float(CHLCNC[0]), float(CHLCNC[-1])))
    logtab = jnp.asarray(np.log(CHLCNC), logc.dtype)
    a1 = jnp.interp(logc, logtab, jnp.asarray(A_1, logc.dtype))
    a2 = jnp.interp(logc, logtab, jnp.asarray(A_2, logc.dtype))
    b1 = jnp.interp(logc, logtab, jnp.asarray(B_1, logc.dtype))
    b2 = jnp.interp(logc, logtab, jnp.asarray(B_2, logc.dtype))
    return a1, a2, b1, b2


def chl_trans_at(coeffs, depth_cm):
    """Transmission Trans(z) = A1 exp(-B1 z) + A2 exp(-B2 z) at arbitrary
    (broadcastable) depths in cm (sw_trans_chl, sw_absorption.F90:730-780)."""
    a1, a2, b1, b2 = coeffs
    z_m = depth_cm * const.MPERCM
    return (a1 * jnp.exp(-jnp.minimum(b1 * z_m, MAXARG))
            + a2 * jnp.exp(-jnp.minimum(b2 * z_m, MAXARG)))


def chl_transmission(cfg: ModelConfig, grid: Grid, chl) -> jnp.ndarray:
    """Per-interface transmission (km+1, ny, nx) from a surface chlorophyll
    field (mg/m^3): interpolate the Ohlmann A/B coefficients in log-chl,
    evaluate Trans(z) = A1 exp(-B1 z) + A2 exp(-B2 z) at layer bottoms.
    The top interface is 1 (the non-penetrative fraction heats the surface
    layer, matching the Jerlov profile convention and QSW_HTP)."""
    km = cfg.km
    a1, a2, b1, b2 = chl_coeffs(chl)
    zw = jnp.reshape(jnp.asarray(np.asarray(grid.vgrid.zw)[:km - 1]),
                     (km - 1, 1, 1))
    tr = chl_trans_at((a1[None], a2[None], b1[None], b2[None]), zw)
    ones = jnp.ones_like(tr[:1])
    return jnp.concatenate([ones, tr, jnp.zeros_like(tr[:1])], axis=0)
