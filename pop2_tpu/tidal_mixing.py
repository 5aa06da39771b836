"""Tidally driven internal-wave mixing (St Laurent/Jayne formulation).

Reference: ``source/tidal_mixing.F90`` — tidal energy flux E(x,y) at the
bottom drives a diffusivity kappa = Gamma q E F(z) / (rho N^2) with the
St Laurent et al. 2002 exponential vertical redistribution F(z)
(init_tidal_mixing2 :1280-1310, tidal_form_coef_jayne :2512-2548); applied
in KPP interior mixing as an addition to the background diffusivity capped
at ``tidal_mix_max`` (vmix_kpp.F90:1755-1835, tidal_compute_diff
:3046-3140).

The time-invariant coefficient Gamma q E F(z) is a dense
(km, ny, nx) array built host-side; the per-step work is one fused
elementwise divide by N^2 inside ``ri_iwmix``.
"""

from __future__ import annotations

import numpy as np

from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig


def energy_flux(cfg: ModelConfig, grid) -> np.ndarray:
    """Tidal energy flux E(x,y) in W/m^2 at T points. From a POP-format
    binary record when ``tidal_energy_file`` is set
    (tidal_read_energy_jayne), else the constant ``tidal_energy_const``."""
    ny, nx = cfg.ny, cfg.nx
    if cfg.tidal_energy_file is not None:
        raw = np.fromfile(cfg.tidal_energy_file, dtype=">f8")
        if raw.size < ny * nx:
            raise ValueError("tidal_energy_file too small")
        return raw[:ny * nx].reshape(ny, nx).astype(np.float64)
    return np.full((ny, nx), cfg.tidal_energy_const)


def build_tidal_coef(cfg: ModelConfig, grid) -> np.ndarray:
    """TIDAL_COEF_3D = (Gamma/rho_fw) * q * E * F(z), masked to the ocean
    column, at interfaces k (0-based index k = interface below layer k).

    F(z): num_k = exp(-(HT - zw_k)/zeta) for k < KMT, 1 at k == KMT;
    denominator = sum_{k<KMT} num_k * dzw_k (init_tidal_mixing2
    :1280-1299). E is converted W/m^2 -> erg/s/cm^2 (*1000, :2231).
    """
    km = cfg.km
    zw = np.asarray(grid.vgrid.zw)          # (km,) interface depths (cm)
    dzw = np.asarray(grid.vgrid.dzw)        # (km+1,)
    HT = np.asarray(grid.HT)
    KMT = np.asarray(grid.KMT)
    RCALCT = np.asarray(grid.RCALCT)
    zeta = cfg.tidal_vertical_decay_scale

    kidx = np.arange(1, km + 1)[:, None, None]   # 1-based level
    num = np.exp(-(HT[None] - zw[:, None, None]) / zeta)
    interior = kidx < KMT[None]
    at_bottom = kidx == KMT[None]
    denom = np.sum(np.where(interior, num * dzw[1:km + 1, None, None], 0.0),
                   axis=0)
    denom = np.where(denom > 0.0, denom, 1.0)
    vert_func = np.where(interior | at_bottom,
                         np.where(at_bottom, 1.0, num) / denom, 0.0)

    qe = (cfg.tidal_local_mixing_fraction * 1000.0
          * energy_flux(cfg, grid))       # erg/s/cm^2
    gamma_rhor = cfg.tidal_mixing_efficiency / const.RHO_FW
    return gamma_rhor * RCALCT[None] * qe[None] * vert_func


# ---------------------------------------------------------------------------
# Schmittner & Egbert (2014) subgrid-scale method
# (init_tidal_mixing2 :1354-1420, tidal_form_coef_schm :2555-2624,
#  Southern-Ocean modification :1410-1435)
# ---------------------------------------------------------------------------

def energy_flux_3d(cfg: ModelConfig, grid) -> np.ndarray:
    """q*E(x,y,z) for the Schmittner method (erg/s/cm^2 per level). From a
    POP binary 3-D record (tidal_energy_file, km records) when available;
    otherwise the 2-D flux deposited in the bottom cell."""
    km, ny, nx = cfg.km, cfg.ny, cfg.nx
    if cfg.tidal_energy_file is not None:
        raw = np.fromfile(cfg.tidal_energy_file, dtype=">f8")
        if raw.size >= km * ny * nx:
            return raw[:km * ny * nx].reshape(km, ny, nx).astype(np.float64)
    e2 = energy_flux(cfg, grid)
    kidx = np.arange(1, km + 1)[:, None, None]
    at_bottom = kidx == np.asarray(grid.KMT)[None]
    return np.where(at_bottom, e2[None], 0.0)


def build_tidal_coef_schmittner(cfg: ModelConfig, grid) -> np.ndarray:
    """TIDAL_COEF_3D(k) = (Gamma/rho) * sum_{k1>k} q*E(k1) *
    exp((zw_k - zw_k1) * zetar) * decay_fn(k1), with the SSJ02 decay
    decay_fn(k) = zetar / (1 - exp(-zetar*zw_k))
    (tidal_form_coef_schm, source/tidal_mixing.F90:2555-2624). The k1 sum
    over deeper levels is a matmul-like weighted suffix accumulation,
    evaluated densely (km <= 62)."""
    km = cfg.km
    zw = np.asarray(grid.vgrid.zw)
    KMT = np.asarray(grid.KMT)
    zetar = 1.0 / cfg.tidal_vertical_decay_scale
    decay_fn = zetar / (1.0 - np.exp(-zetar * zw))

    qe = cfg.tidal_local_mixing_fraction * 1000.0 * energy_flux_3d(cfg, grid)
    gamma_rhor = cfg.tidal_mixing_efficiency / const.RHO_FW

    kidx = np.arange(1, km + 1)
    # weight[k, k1] = exp((zw_k - zw_k1)*zetar) * decay_fn(k1) for k1 > k
    w = np.exp((zw[:, None] - zw[None, :]) * zetar) * decay_fn[None, :]
    w = np.where(kidx[None, :] > kidx[:, None], w, 0.0)     # (km, km)

    in_col = kidx[:, None, None] <= KMT[None]               # k1 <= KMT
    qe_m = np.where(in_col, qe, 0.0)
    coef = np.einsum("kl,lyx->kyx", w, qe_m)
    valid = kidx[:, None, None] < KMT[None]                 # k < KMT
    return gamma_rhor * np.where(valid, coef, 0.0)


def schmittner_socn_floor(cfg: ModelConfig, grid) -> np.ndarray:
    """Southern-Ocean deep-mixing floor (cm^2/s): kappa >= tanh((zw-500m)/
    100m) * (1 - tanh((lat+40)/8))/2 (source/tidal_mixing.F90:1410-1420)."""
    km = cfg.km
    zw = np.asarray(grid.vgrid.zw)[:, None, None]
    tlatd = np.asarray(grid.TLAT) * const.RADIAN
    tanh_zw = np.maximum(np.tanh((zw - 500.0e2) / 100.0e2), 0.0)
    tanh_lat = 0.5 * (1.0 - np.tanh((tlatd[None] + 40.0) / 8.0))
    return tanh_zw * tanh_lat


# ---------------------------------------------------------------------------
# Polzin (2009) / Melet et al. (2013) method
# (init_tidal_mixing2 :1316-1352, tidal_zstarp_inv :3960-4000,
#  tidal_compute_diff_polzin_2D :3147-3255)
# ---------------------------------------------------------------------------

MU_POLZIN = 6.97e-2
NB_REF_POLZIN = 9.6e-4          # 1/s reference bottom buoyancy frequency
KAPPA_POLZIN = 2.0 * np.pi / 125.0 * 1.0e-5   # 1/cm topographic wavenumber
TIDAL_EPS_N2 = 1.0e-14          # 1/s^2 stratification floor


from typing import NamedTuple


class PolzinStatics(NamedTuple):
    """Time-independent Polzin/Melet fields (jit-carriable pytree)."""
    coef2d: object    # (ny, nx) (Gamma/rho) q E
    h2: object        # (ny, nx) topographic roughness^2 (cm^2)
    urms: object      # (ny, nx) barotropic tidal rms speed (cm/s)
    htinv: object     # (ny, nx) 1/HT


def polzin_statics(cfg: ModelConfig, grid) -> PolzinStatics:
    """Build the static Polzin fields; roughness/urms from config constants
    (the reference reads them from tidal_vars_file_polz,
    tidal_read_roughness_RMS)."""
    import jax.numpy as jnp
    HT = np.asarray(grid.HT)
    htinv = np.where(HT != 0.0, 1.0 / np.where(HT != 0.0, HT, 1.0), 1.0e-3)
    qe = cfg.tidal_local_mixing_fraction * 1000.0 * energy_flux(cfg, grid)
    coef2d = (cfg.tidal_mixing_efficiency / const.RHO_FW
              * np.asarray(grid.RCALCT) * qe)
    dt = cfg.jnp_dtype
    return PolzinStatics(
        coef2d=jnp.asarray(coef2d, dt),
        h2=jnp.asarray(np.full_like(HT, cfg.tidal_h2_const), dt),
        urms=jnp.asarray(np.full_like(HT, cfg.tidal_urms_const), dt),
        htinv=jnp.asarray(htinv, dt))


def polzin_diff(cfg: ModelConfig, grid, statics: PolzinStatics, n2):
    """Per-step Polzin/Melet tidal diffusivity (km, ny, nx at interfaces).

    n2: (km, ny, nx) buoyancy frequency squared at interfaces below each
    level (DBLOC/dzw). Vectorizes the reference's per-level column calls:
      zstarp_inv = kappa^2/(mu Nbref^2) * H2 * N_b * <N^2> / u_rms
      K(z) = coef2d * N^2/(N^2+omega^2)
             * (1/H + zstarp_inv) / <N^2> / (1 + z*(z)*zstarp_inv)^2
    with z*(z) = int_z^bottom N^2 dz' / <N^2>
    (tidal_compute_diff_polzin_2D, source/tidal_mixing.F90:3147-3255).
    """
    import jax
    import jax.numpy as jnp
    km = cfg.km
    dzw = jnp.reshape(jnp.asarray(np.asarray(grid.vgrid.dzw))[1:km + 1],
                      (km, 1, 1)).astype(n2.dtype)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    kmt = grid.KMT[None]
    in_col = kidx <= kmt - 1                   # interfaces above the bottom

    n2f = jnp.where(in_col, jnp.maximum(n2, TIDAL_EPS_N2), 0.0)

    # suffix integral of N^2 (from each interface down to the sea floor)
    n2dz = n2f * dzw
    n2_int = (jnp.cumsum(n2dz[::-1], axis=0)[::-1])
    n2_avg_int = n2_int[0]                     # full-depth integral
    n2_avg = n2_avg_int * statics.htinv       # <N^2>
    n2_avg_safe = jnp.where(n2_avg > 0.0, n2_avg, 1.0)

    # N at the sea floor
    at_bot = kidx == kmt - 1
    nb = jnp.sqrt(jnp.sum(jnp.where(at_bot, n2f, 0.0), axis=0))

    zstar_inv_coeff = KAPPA_POLZIN ** 2 / (MU_POLZIN * NB_REF_POLZIN ** 2)
    urms_safe = jnp.where(statics.urms != 0.0, statics.urms, 1.0)
    zstarp_inv = jnp.where(
        statics.urms != 0.0,
        zstar_inv_coeff * statics.h2 * nb * n2_avg / urms_safe, 0.0)

    zstarz = n2_int / n2_avg_safe[None]        # z*(z)
    shape_fac = ((statics.htinv + zstarp_inv)[None] / n2_avg_safe[None]
                 / (1.0 + zstarz * zstarp_inv[None]) ** 2)
    freq_fac = n2f / (n2f + (const.OMEGA ** 2))
    diff = jnp.where(in_col,
                     freq_fac * statics.coef2d[None] * shape_fac, 0.0)
    return diff


# ---------------------------------------------------------------------------
# 18.6-year lunar nodal cycle (LNC) modulation
# (source/tidal_mixing.F90:419-520, 1462-1742: the reference reads
# per-constituent daily modulation timeseries; rebuilt here from the
# standard Doodson nodal amplitude factors, which is what those files
# contain — energy scales as the squared amplitude factor)
# ---------------------------------------------------------------------------

LNC_PERIOD_YEARS = 18.613
#: epoch (year) at which the lunar ascending-node longitude N = 0
LNC_EPOCH_YEAR = 1969.9
#: share of the barotropic tidal dissipation by constituent (Egbert & Ray)
LNC_ENERGY_WEIGHTS = {"m2": 0.68, "s2": 0.17, "k1": 0.10, "o1": 0.05}
#: amplitude nodal-factor coefficients f = 1 + a*cos(N) (Doodson); solar
#: S2 carries no lunar modulation
LNC_AMP_COEF = {"m2": -0.0373, "s2": 0.0, "k1": 0.1150, "o1": 0.1885}


def lunar_nodal_modulation(year_frac: float) -> float:
    """Energy-weighted tidal-dissipation modulation factor at decimal year
    ``year_frac``: sum_c w_c (1 + a_c cos N)^2 with N the lunar node
    longitude (period 18.613 yr). Multiplies the tidal energy (and hence
    the tidal diffusivity) when ltidal_lunar_cycle is active."""
    n = 2.0 * np.pi * (year_frac - LNC_EPOCH_YEAR) / LNC_PERIOD_YEARS
    return float(sum(w * (1.0 + LNC_AMP_COEF[c] * np.cos(n)) ** 2
                     for c, w in LNC_ENERGY_WEIGHTS.items()))
