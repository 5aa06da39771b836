"""Gent-McWilliams eddy transport + Redi isopycnal diffusion (skew-flux form).

Reference: ``source/hmix_gm.F90`` (hdifft_gm :1102-2219, init :283-1095) and
``source/hmix_gm_submeso_share.F90`` (tracer_diffs_and_isopyc_slopes
:149-434). Implemented for the standard production path: constant or equal
isopycnal/thickness diffusivities, 'notanh' or 'clip' slope control, Large et
al. (1997) near-surface Rossby-radius taper, surface-boundary-layer
horizontal diffusion, and the |S|^2 vertical flux folded into the implicit
vertical diffusivity (VDC_GM). Transition-layer and flow-dependent kappa
options follow in a later round.

The reference's level-by-level sweep with carried two-level ring
buffers and the FZTOP carry becomes whole-column arrays; every quantity is
computed for all (half, face, k) at once and the vertical flux divergence is
a shifted difference.

Slope indexing: arrays carry a leading axis pair (face, half) with
face 0 = east/north, face 1 = west/south; half 0 = top (ktp), 1 = bottom
(kbt) — matching the reference's (ieast/iwest, ktp/kbt) quarter cells.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pop2_tpu import eos
from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid
from pop2_tpu.stencil import BC, ugrid_to_tgrid

EPS = 1.0e-10
EPS2 = 1.0e-20


class GMOut(NamedTuple):
    gtk: jnp.ndarray       # (nt, km, ny, nx) tracer tendency
    vdc_gm: jnp.ndarray    # (km, ny, nx) addition to implicit diffusivity
    # diagnostics for the tavg registry (KAPPA_ISOP/KAPPA_THIC/HOR_DIFF
    # accumulations, source/hmix_gm.F90:1401-1421,1630): cell averages of
    # the tapered top/bottom-half diffusivities
    kappa_isop: jnp.ndarray = None   # (km, ny, nx)
    kappa_thic: jnp.ndarray = None   # (km, ny, nx)
    hor_diff: jnp.ndarray = None     # (km, ny, nx)
    # transition-layer diagnostics (DIA_DEPTH/TLT/INT_DEPTH tavg fields,
    # source/hmix_gm.F90:2198-2209); None when the scheme is off
    dia_depth: jnp.ndarray = None    # (ny, nx) diabatic-layer depth
    tlt_thick: jnp.ndarray = None    # (ny, nx) transition-layer thickness
    int_depth: jnp.ndarray = None    # (ny, nx) interior-region start depth


class TLT(NamedTuple):
    """Transition-layer fields (the reference's TLT derived type,
    source/hmix_gm.F90:222-245)."""
    diabatic_depth: jnp.ndarray   # (ny, nx) base of the diabatic region
    thickness: jnp.ndarray        # (ny, nx) transition-layer thickness
    interior_depth: jnp.ndarray   # (ny, nx) start of the adiabatic interior
    k_level: jnp.ndarray          # (ny, nx) int32, 1-based level of the base
    ztw: jnp.ndarray              # (ny, nx) int32, 1 = base at zt, 2 = at zw


def face_density_diffs(cfg: ModelConfig, grid: Grid, bc: BC, ts_range,
                       tmix):
    """Tracer face differences and face/vertical density differences
    shared by GM and the submesoscale scheme
    (tracer_diffs_and_isopyc_slopes,
    source/hmix_gm_submeso_share.F90:149-434).

    Returns (tx, ty, tz, rx, ry, rz_ktp_raw, rz_kbt_raw) with
      tx/ty: (nt, km, ny, nx) masked east/north face differences,
      tz:    (nt, km, ny, nx) with tz[:, k] = T_{k-1} - T_k (tz[:, 0] = 0),
      rx/ry: (2 faces, km, ny, nx) density diffs (0 = east/north,
             1 = west/south, the reference's ieast/iwest, jnorth/jsouth),
      rz_*:  unclamped vertical density differences at the interface above
             (ktp) / below (kbt) each level, level-k coefficients.
    """
    km = cfg.km
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    kmaske = ((kidx <= grid.KMT[None]) & (kidx <= grid.KMTE[None]))
    kmaskn = ((kidx <= grid.KMT[None]) & (kidx <= grid.KMTN[None]))

    tx = jnp.where(kmaske[None], bc.e(tmix) - tmix, 0.0)
    ty = jnp.where(kmaskn[None], bc.n(tmix) - tmix, 0.0)

    tclip = jnp.maximum(tmix[0], -2.0)
    txp = jnp.where(kmaske, bc.e(tclip) - tclip, 0.0)
    typ = jnp.where(kmaskn, bc.n(tclip) - tclip, 0.0)

    tz = jnp.concatenate(
        [jnp.zeros_like(tmix[:, :1]), tmix[:, :-1] - tmix[:, 1:]], axis=1)
    tzp_c = jnp.concatenate(
        [jnp.zeros_like(tclip[:1]), tclip[:-1] - tclip[1:]], axis=0)

    _, drdt, drds = eos.state(cfg, grid.vgrid.pressz, tmix[0], tmix[1],
                              ts_range, want_drhodt=True, want_drhods=True)

    # face density differences with this cell's expansion coefficients
    rx = jnp.stack([drdt * txp + drds * tx[1],
                    drdt * bc.w(txp) + drds * bc.w(tx[1])])
    ry = jnp.stack([drdt * typ + drds * ty[1],
                    drdt * bc.s(typ) + drds * bc.s(ty[1])])

    # vertical density differences: for the bottom half of level k the
    # interface below k uses level-k coefficients with TZ at k+1; for the
    # top half the interface above k uses level-k coefficients with TZ at k
    tzp_kp1 = jnp.concatenate([tzp_c[1:], jnp.zeros_like(tzp_c[:1])], axis=0)
    tzs_kp1 = jnp.concatenate([tz[1, 1:], jnp.zeros_like(tz[1, :1])], axis=0)
    rz_kbt_raw = drdt * tzp_kp1 + drds * tzs_kp1
    rz_ktp_raw = drdt * tzp_c + drds * tz[1]
    return tx, ty, tz, rx, ry, rz_ktp_raw, rz_kbt_raw


def _slopes(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix):
    """Isopycnal slopes per quarter cell (see face_density_diffs).

    Returns (tx, ty, tz, slx, sly) with
      slx:   (2 faces, 2 halves, km, ny, nx) x-slopes, sly likewise.
    """
    km = cfg.km
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    tx, ty, tz, rx, ry, rz_ktp_raw, rz_kbt_raw = face_density_diffs(
        cfg, grid, bc, ts_range, tmix)
    rx_e, rx_w = rx[0], rx[1]
    ry_n, ry_s = ry[0], ry[1]
    rz_kbt = jnp.minimum(rz_kbt_raw, -EPS2)
    rz_ktp = jnp.minimum(rz_ktp_raw, -EPS2)

    below_mask = (kidx < grid.KMT[None])      # k < KMT
    in_mask = (kidx <= grid.KMT[None])

    def mk_sl(r, rz, mask):
        return jnp.where(mask, r / rz, 0.0)

    slx_kbt = jnp.stack([mk_sl(rx_e, rz_kbt, below_mask),
                         mk_sl(rx_w, rz_kbt, below_mask)])
    sly_kbt = jnp.stack([mk_sl(ry_n, rz_kbt, below_mask),
                         mk_sl(ry_s, rz_kbt, below_mask)])
    slx_ktp = jnp.stack([mk_sl(rx_e, rz_ktp, in_mask),
                         mk_sl(rx_w, rz_ktp, in_mask)])
    sly_ktp = jnp.stack([mk_sl(ry_n, rz_ktp, in_mask),
                         mk_sl(ry_s, rz_ktp, in_mask)])
    # top half of level 1 has no interface above
    slx_ktp = slx_ktp.at[:, 0].set(0.0)
    sly_ktp = sly_ktp.at[:, 0].set(0.0)

    slx = jnp.stack([slx_ktp, slx_kbt], axis=1)  # (face, half, km, ny, nx)
    sly = jnp.stack([sly_ktp, sly_kbt], axis=1)
    return tx, ty, tz, slx, sly


def _sla(cfg: ModelConfig, grid: Grid, slx, sly):
    """Absolute-slope measure |S| per (half, k) (SLA / SLA_SAVE,
    source/hmix_gm.F90:1236-1242, 1431-1436); kid = k-1 for ktp, k for
    kbt. Returns (2 halves, km, ny, nx)."""
    km = cfg.km
    dzw = grid.vgrid.dzw
    dzw_h = jnp.stack([
        jnp.reshape(dzw[0:km], (km, 1, 1)),
        jnp.reshape(dzw[1:km + 1], (km, 1, 1))])
    return dzw_h * jnp.sqrt(0.5 * (
        (slx[0] ** 2 + slx[1] ** 2) / grid.DXT[None, None] ** 2
        + (sly[0] ** 2 + sly[1] ** 2) / grid.DYT[None, None] ** 2)) + EPS


def _tapers(cfg: ModelConfig, grid: Grid, sla, bl_depth, tlt=None):
    """Near-surface Rossby-radius taper (Large et al. 1997) and slope
    control (source/hmix_gm.F90:1405-1601, 'notanh'). With the transition
    layer active, the Rossby taper is skipped (TAPER1 = 1, :1440) and the
    slope tapers are disabled inside the diabatic region (:1596-1601).
    Returns (taper_isop, taper_thic, taper1, taper2), each
    (2 halves, km, ny, nx)."""
    km = cfg.km
    zt = grid.vgrid.zt

    if tlt is None:
        # inverse Rossby radius |f|/c1, bounded to [15 km, 100 km]
        # (source/hmix_gm.F90:889-894)
        rbr = jnp.clip(jnp.abs(grid.FCORT) / 200.0, 1.0e-7, 1.0 / 1.5e6)
        w1 = jnp.minimum(1.0, jnp.reshape(zt, (1, km, 1, 1)) * rbr / sla)
        taper1 = 0.5 + 2.0 * (w1 - 0.5) * (1.0 - jnp.abs(w1 - 0.5))
        zt_above = jnp.concatenate([jnp.zeros_like(zt[:1]), zt[:-1]])
        in_bl = jnp.reshape(zt_above, (1, km, 1, 1)) <= bl_depth
        taper1 = jnp.where(in_bl, taper1, 1.0)
    else:
        taper1 = jnp.ones_like(sla)

    def notanh(sla, slm):
        x = sla / slm
        mid = 0.5 * (1.0 - (2.5 * x - 1.0) * (4.0 - jnp.abs(10.0 * x - 4.0)))
        return jnp.where(x <= 0.2, 1.0, jnp.where(x >= 0.6, 0.0, mid))

    taper2 = notanh(sla, cfg.gm_slm_r)
    taper3 = (notanh(sla, cfg.gm_slm_b)
              if cfg.gm_slm_b != cfg.gm_slm_r else taper2)

    if tlt is not None:
        # no slope tapering inside the diabatic region; the taper test
        # depths are zt(k+1) (ktp) / zw(k+1) (kbt) (:1406-1411)
        ztv = np.asarray(grid.vgrid.zt)
        zwv = np.asarray(grid.vgrid.zw)
        kp1 = np.minimum(np.arange(1, km + 1), km - 1)
        ref_ktp = ztv[kp1]
        ref_ktp[km - 1] = zwv[km - 1]
        ref_kbt = zwv[kp1]
        ref_d = jnp.reshape(jnp.asarray(np.stack([ref_ktp, ref_kbt])),
                            (2, km, 1, 1))
        in_dia = ref_d <= tlt.diabatic_depth[None, None]
        taper2 = jnp.where(in_dia, 1.0, taper2)
        taper3 = jnp.where(in_dia, 1.0, taper3)

    return taper1 * taper2, taper1 * taper3, taper1, taper2


# ---------------------------------------------------------------------------
# Flow-dependent diffusivity variants
# (kappa_lon_lat_vmhs source/hmix_gm.F90:2226-2456,
#  kappa_eg :2463-2659, kappa_type_depth profile :850-872)
# ---------------------------------------------------------------------------

def _btp(grid: Grid, bc: BC):
    """Beta at T points (source/hmix_gm.F90:902-904)."""
    lat_t = ugrid_to_tgrid(grid.ULAT, bc)
    return 2.0 * const.OMEGA * jnp.cos(lat_t) / const.RADIUS


def _displaced_density_diff(cfg, grid, ts_range, tmix, clamp=True):
    """WORK3 = drho/dT*(T_k - T_{k+1}) + drho/dS*(S_k - S_{k+1}) with
    level-k coefficients displaced to level-(k+1) pressure, T clamped at
    -2C and the result clamped <= -eps2 (the shared stratification measure
    of kappa_lon_lat_vmhs :2320-2331 and kappa_eg :2546-2556). With
    clamp=False the raw difference is returned (the bfre N^2 profile,
    :3104-3111, applies max(0, .) instead)."""
    pz = grid.vgrid.pressz
    pz_kp1 = jnp.concatenate([pz[1:], pz[-1:]])
    _, drdt, drds = eos.state(cfg, pz_kp1, tmix[0], tmix[1], ts_range,
                              want_drhodt=True, want_drhods=True)
    tclip = jnp.maximum(tmix[0], -2.0)
    t_kp1 = jnp.concatenate([tclip[1:], tclip[-1:]], axis=0)
    s_kp1 = jnp.concatenate([tmix[1, 1:], tmix[1, -1:]], axis=0)
    work3 = drdt * (tclip - t_kp1) + drds * (tmix[1] - s_kp1)
    return jnp.minimum(work3, -EPS2) if clamp else work3


def kappa_vertical_bfre(cfg: ModelConfig, grid: Grid, ts_range, tmix, sdl,
                        n2=None):
    """Normalized buoyancy-frequency vertical profile KAPPA_VERTICAL =
    clip(N^2 / N^2_ref, 0.1, 1) at T points — the production 'bfre' kappa
    vertical structure (buoyancy_frequency_dependent_profile,
    source/hmix_gm.F90:3011-3176). ``sdl`` is the surface-diabatic-layer
    depth (zw(1) / KPP HBLT / TLT interior depth, :3085-3087).

    Returns (km, ny, nx); 1 at and above the reference level."""
    km = cfg.km
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    dzwr = jnp.reshape(grid.vgrid.dzwr[1:km + 1], (km, 1, 1))
    zw = jnp.reshape(jnp.asarray(grid.vgrid.zw), (km, 1, 1))

    below = kidx < grid.KMT[None]
    if n2 is None:
        work3 = _displaced_density_diff(cfg, grid, ts_range, tmix,
                                        clamp=False)
        n2 = jnp.where(below,
                       jnp.maximum(0.0, -const.GRAV * work3 * dzwr), 0.0)

    # reference level: first k with zw(k) > SDL, k <= KMT, N^2 > 0 (:3126-
    # 3133; the loop runs k=1..km-1 so the bottom interface never qualifies)
    cand = (zw > sdl[None]) & (kidx <= grid.KMT[None]) & (n2 > 0.0)
    cand = cand.at[-1].set(False)
    exists = jnp.any(cand, axis=0)
    k_min0 = jnp.argmax(cand, axis=0)              # 0-based level index
    # one-hot masked reduction (see kpp.blmix.gather)
    oh_ref = (jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0)
              == k_min0[None]).astype(n2.dtype)
    n2_ref = jnp.sum(n2 * oh_ref, axis=0)
    k_min = jnp.where(exists, k_min0 + 1, km + 1)  # 1-based; km+1 = none

    norm = jnp.where((kidx >= k_min[None]) & below & exists[None]
                     & (n2_ref[None] != 0.0),
                     jnp.clip(n2 / jnp.where(n2_ref[None] == 0.0, 1.0,
                                             n2_ref[None]), 0.1, 1.0),
                     1.0)
    # copy the last interior interface value to the bottom one (:3153-3157)
    norm_up = jnp.concatenate([norm[:1], norm[:-1]], axis=0)
    norm = jnp.where(kidx == grid.KMT[None], norm_up, norm)

    # copy interface values from above to T points, preserving extrema
    # (:3167-3171): KAPPA_VERTICAL(k) = NORM(k-1) for K_MIN < k <= KMT
    kv = jnp.where((kidx > k_min[None]) & (kidx <= grid.KMT[None]),
                   norm_up, 1.0)
    return kv


def _rossby_radius(grid: Grid):
    """Rossby deformation radius RB = Cg/|f| bounded to [15 km, 100 km]
    (source/hmix_gm.F90:887-898), cm."""
    rbr = jnp.clip(jnp.abs(grid.FCORT) / 200.0, 1.0e-7, 1.0 / 1.5e6)
    return 1.0 / rbr


def transition_layer(cfg: ModelConfig, grid: Grid, diabatic_depth, sla,
                     rb) -> TLT:
    """Transition-layer thickness/extent search (transition_layer,
    source/hmix_gm.F90:3183-3434). ``sla`` is the (half, km, ny, nx)
    absolute-slope measure SLA_SAVE (:1236-1242); ``rb`` the Rossby radius.

    The reference's three sequential k sweeps with per-column state become
    lax.scan's over stacked per-level constants."""
    km = cfg.km
    zt = np.asarray(grid.vgrid.zt)
    zw = np.asarray(grid.vgrid.zw)
    dd = diabatic_depth
    kmt = grid.KMT
    shape = dd.shape
    i32 = jnp.int32

    zeros = jnp.zeros(shape, dd.dtype)
    izeros = jnp.zeros(shape, i32)

    # ---- pass 1 (:3248-3276): minimum thickness = down to the first grid
    # interface (zw) or center (zt) below the diabatic depth.  The
    # reference's k sweep is a first-k search — closed form (zw is
    # monotone), no scan: one (km, ny, nx) comparison + 2-D gathers.
    ks = jnp.arange(1, km + 1, dtype=i32)
    zwj = jnp.asarray(zw, dd.dtype)
    ztj = jnp.asarray(zt, dd.dtype)
    lt = dd[None] < zwj[:, None, None]
    fired = jnp.any(lt, axis=0) & (kmt != 0)
    kidx0 = jnp.argmax(lt, axis=0)                 # first 0-based fire k
    k1b = (kidx0 + 1).astype(i32)
    zw_k = zwj[kidx0]
    zt_k = ztj[kidx0]
    c2 = fired & (k1b != 1) & (dd < zt_k)
    k_level = jnp.where(fired, k1b, izeros)
    k_sub = jnp.where(c2, jnp.ones_like(izeros), izeros)
    thick = jnp.where(fired, jnp.where(c2, zt_k - dd, zw_k - dd), zeros)
    ztw = jnp.where(fired, jnp.where(c2, 1, 2).astype(i32), izeros)
    k_start = jnp.where(fired, jnp.where(c2, k1b, k1b + 1), izeros)

    # ---- pass 2 (:3297-3331): extend through levels whose Rossby-scale
    # vertical displacement R*|S| reaches above the diabatic depth
    # (columns whose minimum layer ended at a cell center, K_SUB = kbt)
    compute = ~((kmt == 0) | (k_start > kmt)
                | ((k_start == kmt) & (k_sub == 1)))

    sla_kbt = sla[1]                                        # (km, ny, nx)
    sla_ktp = sla[0]
    sla_ktp_kp1 = jnp.concatenate(
        [sla_ktp[1:], jnp.zeros_like(sla_ktp[:1])], axis=0)

    def pass2(carry, xs):
        k, zwk, s_kbt_k, s_ktp_kp1 = xs
        k_start, k_sub, thick, k_level, ztw, compute = carry
        work = jnp.where(compute & (k_sub == 1) & (k_start < kmt)
                         & (k_start == k),
                         jnp.maximum(s_kbt_k, s_ktp_kp1) * rb, 0.0)
        stop = (work != 0.0) & (dd < (zwk - work))
        compute = compute & ~stop
        grow = (work != 0.0) & (dd >= (zwk - work))
        k_start = jnp.where(grow, k_start + 1, k_start)
        k_sub = jnp.where(grow, 0, k_sub)
        thick = jnp.where(grow, zwk - dd, thick)
        k_level = jnp.where(grow, k, k_level)
        ztw = jnp.where(grow, 2, ztw)
        return (k_start, k_sub, thick, k_level, ztw, compute), None

    (k_start, k_sub, thick, k_level, ztw, compute), _ = jax.lax.scan(
        pass2, (k_start, k_sub, thick, k_level, ztw, compute),
        (ks[:km - 1], jnp.asarray(zw[:km - 1]), sla_kbt[:km - 1],
         sla_ktp_kp1[:km - 1]))

    # ---- pass 3 (:3339-3388): deeper levels, checking both the top
    # (zt) and bottom (zw) halves of each level
    def pass3(carry, xs):
        k, ztk, zwk, s_ktp_k, s_kbt_k, s_ktp_kp1 = xs
        k_start, thick, k_level, ztw, compute = carry
        for kk, refd in ((0, ztk), (1, zwk)):
            if kk == 0:
                work = jnp.where(compute & (k_start <= kmt)
                                 & (k_start == k),
                                 jnp.maximum(s_ktp_k, s_kbt_k) * rb, 0.0)
            else:
                work = jnp.where(compute & (k_start < kmt)
                                 & (k_start == k) & (k < km),
                                 jnp.maximum(s_kbt_k, s_ktp_kp1) * rb, 0.0)
                work = jnp.where(compute & (k_start == kmt)
                                 & (k_start == k),
                                 s_kbt_k * rb, work)
            stop = (work != 0.0) & (dd < (refd - work))
            compute = compute & ~stop
            grow = (work != 0.0) & (dd >= (refd - work))
            thick = jnp.where(grow, refd - dd, thick)
            k_level = jnp.where(grow, k, k_level)
            ztw = jnp.where(grow, kk + 1, ztw)
        k_start = jnp.where(compute & (k_start == k), k_start + 1, k_start)
        return (k_start, thick, k_level, ztw, compute), None

    (k_start, thick, k_level, ztw, _), _ = jax.lax.scan(
        pass3, (k_start, thick, k_level, ztw, compute),
        (ks[1:], jnp.asarray(zt[1:]), jnp.asarray(zw[1:]),
         sla_ktp[1:], sla_kbt[1:], sla_ktp_kp1[1:]))

    # ---- interior-region start depth (:3404-3413)
    klev0 = jnp.clip(k_level - 1, 0, km - 1)
    int_depth = jnp.where(
        ztw == 1, jnp.asarray(zt)[klev0],
        jnp.where(ztw == 2, jnp.asarray(zw)[klev0], 0.0))
    int_depth = jnp.where(kmt > 0, int_depth, 0.0)

    return TLT(diabatic_depth=dd, thickness=jnp.where(kmt > 0, thick, 0.0),
               interior_depth=int_depth, k_level=k_level, ztw=ztw)


def merged_streamfunction(cfg: ModelConfig, grid: Grid, tlt: TLT, kthic,
                          slx, sly):
    """Merged eddy-induced streamfunction SF = kappa_thic * S * dz with
    linear interpolation through the diabatic region and quadratic
    interpolation through the transition layer (merged_streamfunction,
    source/hmix_gm.F90:3441-3738).

    kthic: (half, km, ny, nx); slx/sly: (face, half, km, ny, nx).
    Returns (sf_slx, sf_sly) of shape (face, half, km, ny, nx)."""
    km = cfg.km
    dz = np.asarray(grid.vgrid.dz)
    zt = np.asarray(grid.vgrid.zt)
    dzwr = np.asarray(grid.vgrid.dzwr)
    kmt = grid.KMT

    klev = tlt.k_level                                    # 1-based; 0 = none
    k0 = jnp.clip(klev - 1, 0, km - 1)                    # 0-based gather

    def gat_k(a, dk, axis):
        idx = jnp.clip(k0 + dk, 0, km - 1)
        bshape = [1] * a.ndim
        bshape[axis] = 1
        idx_b = jnp.broadcast_to(
            idx, a.shape[:axis] + (1,) + a.shape[axis + 1:])
        return jnp.take_along_axis(a, idx_b, axis=axis)

    def gv(vec, dk):
        return jnp.asarray(vec)[jnp.clip(k0 + dk, 0, km - 1)]

    # gathered level constants and fields at K_LEVEL (k), k+1, k+2
    dz_k, dz_kp1, dz_kp2 = gv(dz, 0), gv(dz, 1), gv(dz, 2)
    dzwr_k = gv(dzwr[1:km + 1], 0)
    dzwr_kp1 = gv(dzwr[1:km + 1], 1)

    def work_pair(sl):
        """WORK1 (streamfunction) and WORK2 (first derivative) at the
        interior-depth level for one slope field; (face, ny, nx) each."""
        kth_kbt_k = gat_k(kthic[1:2], 0, 1)[0]            # (1? ny nx)
        kth_ktp_kp1 = gat_k(kthic[0:1], 1, 1)[0]
        kth_kbt_kp1 = gat_k(kthic[1:2], 1, 1)[0]
        kth_ktp_kp2 = gat_k(kthic[0:1], 2, 1)[0]

        sl_kbt_k = gat_k(sl[:, 1], 0, 1)[:, 0]            # (face, ny, nx)
        sl_ktp_kp1 = gat_k(sl[:, 0], 1, 1)[:, 0]
        sl_kbt_kp1 = gat_k(sl[:, 1], 1, 1)[:, 0]
        sl_ktp_kp2 = gat_k(sl[:, 0], 2, 1)[:, 0]

        m1 = (tlt.ztw == 1) & (klev < kmt) & (klev > 0)   # base at zt(k)
        w1_a = kth_kbt_k * sl_kbt_k * dz_k
        w2_a = 2.0 * dzwr_k * (w1_a - kth_ktp_kp1 * sl_ktp_kp1 * dz_kp1)
        w2n_a = 2.0 * (kth_ktp_kp1 * sl_ktp_kp1
                       - kth_kbt_kp1 * sl_kbt_kp1)
        w2_a = jnp.where(jnp.abs(w2n_a) < jnp.abs(w2_a), w2n_a, w2_a)

        m2 = (tlt.ztw == 2) & (klev < kmt) & (klev > 0)   # base at zw(k)
        w1_b0 = kth_ktp_kp1 * sl_ktp_kp1
        w2_b = 2.0 * (w1_b0 - kth_kbt_kp1 * sl_kbt_kp1)
        w1_b = w1_b0 * dz_kp1
        deeper = m2 & (klev + 1 < kmt)                    # => k+2 in range
        w2n_b = 2.0 * dzwr_kp1 * (kth_kbt_kp1 * sl_kbt_kp1 * dz_kp1
                                  - kth_ktp_kp2 * sl_ktp_kp2 * dz_kp2)
        w2_b = jnp.where(deeper & (jnp.abs(w2n_b) < jnp.abs(w2_b)),
                         w2n_b, w2_b)

        w1 = jnp.where(m1, w1_a, jnp.where(m2, w1_b, 0.0))
        w2 = jnp.where(m1, w2_a, jnp.where(m2, w2_b, 0.0))
        return w1, w2

    wx1, wx2 = work_pair(slx)
    wy1, wy2 = work_pair(sly)

    # interpolation factors (:3613-3622)
    w5 = jnp.where(kmt != 0,
                   1.0 / (2.0 * tlt.diabatic_depth + tlt.thickness), 0.0)
    w6 = jnp.where((kmt != 0) & (tlt.thickness > EPS),
                   w5 / jnp.where(tlt.thickness > EPS, tlt.thickness, 1.0),
                   0.0)

    # per-(half, k) reference depths: mid top / bottom quarter of the cell
    ref_d = np.stack([zt - 0.25 * dz, zt + 0.25 * dz])    # (2, km)
    ref_d = jnp.reshape(jnp.asarray(ref_d), (1, 2, km, 1, 1))

    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    in_col = (kidx <= kmt[None])[None, None]

    dd = tlt.diabatic_depth[None, None, None]
    idp = tlt.interior_depth[None, None, None]
    z_dia = (ref_d <= dd) & in_col
    z_tl = (ref_d > dd) & (ref_d <= idp) & in_col
    z_int = (ref_d > idp) & in_col

    def merge_sf(w1, w2, sl, kth):
        lin = ref_d * w5 * (2.0 * w1[:, None, None]
                            + tlt.thickness * w2[:, None, None])
        quad = (-(dd - ref_d) ** 2 * w6
                * (w1[:, None, None] + idp * w2[:, None, None]) + lin)
        interior = kth[None] * sl * jnp.reshape(jnp.asarray(dz),
                                                (1, 1, km, 1, 1))
        return jnp.where(z_dia, lin,
                         jnp.where(z_tl, quad,
                                   jnp.where(z_int, interior, 0.0)))

    return merge_sf(wx1, wx2, slx, kthic), merge_sf(wy1, wy2, sly, kthic)


def apply_transition_profile(cfg: ModelConfig, grid: Grid, tlt: TLT,
                             kisop, hor_diff):
    """Vertical tapering of KAPPA_ISOP and HOR_DIFF across the diabatic /
    transition / interior regions (apply_vertical_profile_to_isop_hor_diff,
    source/hmix_gm.F90:3745-3840). Both args (half, km, ny, nx)."""
    km = cfg.km
    dz = np.asarray(grid.vgrid.dz)
    zt = np.asarray(grid.vgrid.zt)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    in_col = (kidx <= grid.KMT[None])[None]

    ref_d = jnp.reshape(jnp.asarray(
        np.stack([zt - 0.25 * dz, zt + 0.25 * dz])), (2, km, 1, 1))
    dd = tlt.diabatic_depth[None, None]
    idp = tlt.interior_depth[None, None]
    thick = tlt.thickness[None, None]

    z_dia = (ref_d <= dd) & in_col
    z_tl = (ref_d > dd) & (ref_d <= idp) & in_col & (thick > EPS)
    z_int = (ref_d > idp) & in_col

    safe_thick = jnp.where(thick > EPS, thick, 1.0)
    kisop = jnp.where(z_dia, 0.0, kisop)
    kisop = jnp.where(z_tl, (ref_d - dd) * kisop / safe_thick, kisop)
    hor_diff = jnp.where(z_tl, (idp - ref_d) * hor_diff / safe_thick,
                         hor_diff)
    hor_diff = jnp.where(z_int, 0.0, hor_diff)
    return kisop, hor_diff


def kappa_vmhs(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
               umix, vmix_m):
    """Visbeck et al. (1997) lateral diffusivity KAPPA_LATERAL = C l^2/T
    (kappa_lon_lat_vmhs, source/hmix_gm.F90:2226-2456). Returns (ny, nx),
    cm^2/s, bounded to [3.0e6, 4.0e7]."""
    km = cfg.km
    zt = np.asarray(grid.vgrid.zt)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1

    # integration limits: -2000m < z < -100m (:2290); k1/k2 are static
    in_range = (zt >= 1.0e4) & (zt <= 2.0e5)
    k1 = int(np.argmax(in_range)) + 1                       # 1-based
    above = np.where(~in_range & (np.arange(km) + 1 > k1))[0]
    k2 = int(above[0]) + 1 if len(above) else km            # 1-based

    work3 = _displaced_density_diff(cfg, grid, ts_range, tmix)
    ut = ugrid_to_tgrid(umix, bc)
    vt = ugrid_to_tgrid(vmix_m, bc)
    ut_kp1 = jnp.concatenate([ut[1:], ut[-1:]], axis=0)
    vt_kp1 = jnp.concatenate([vt[1:], vt[-1:]], axis=0)

    dzw = jnp.reshape(grid.vgrid.dzw[1:km + 1], (km, 1, 1))
    contrib = (kidx >= k1) & (kidx < k2) & (kidx < grid.KMT[None])
    rnum = -dzw / ((ut - ut_kp1) ** 2 + (vt - vt_kp1) ** 2 + EPS)
    grate = jnp.sum(jnp.where(contrib,
                              const.GRAV * rnum * dzw * work3, 0.0), axis=0)
    lsc = jnp.sum(jnp.where(contrib, -const.GRAV * work3, 0.0), axis=0)

    # normalize by the actually-integrated depth span (:2399-2410)
    zt_j = jnp.asarray(zt)
    kmt0 = jnp.maximum(grid.KMT - 1, 0)
    zt_kmt = zt_j[kmt0]
    zmin1 = jnp.minimum(zt[k1 - 1], zt_kmt)
    zmin2 = jnp.minimum(zt[k2 - 1], zt_kmt)
    span = zmin2 - zmin1
    grate = grate / (span + EPS)               # mean Ri
    lsc = lsc * span                           # c_g^2 = N^2 H^2

    btp = _btp(grid, bc)
    w1 = jnp.sqrt(2.0 * jnp.sqrt(jnp.maximum(lsc, 0.0)) * btp)
    w2 = jnp.sqrt(jnp.maximum(lsc, 0.0)) / (2.0 * btp)
    inv_t = jnp.maximum(jnp.abs(grid.FCORT), w1)
    grate = inv_t / jnp.sqrt(jnp.maximum(grate, 0.0) + EPS)   # 1/T
    lsc = lsc / (grid.FCORT + EPS) ** 2                       # L^2
    lsc = jnp.minimum(lsc, w2)
    lsc = jnp.maximum(lsc, jnp.minimum(grid.DXT ** 2, grid.DYT ** 2))

    kappa = jnp.clip(0.13 * grate * lsc, 3.0e6, 4.0e7)
    return jnp.where(grid.KMT <= k1, 3.0e6, kappa)


def _sigma_topo_mask(grid: Grid, bc: BC, km: int):
    """1 where k < KMT and no 8-neighbor bottom sits at exactly level k
    (source/hmix_gm.F90:1001-1030)."""
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    kmt = grid.KMT
    neigh = [bc.e(kmt), bc.w(kmt), bc.n(kmt), bc.s(kmt),
             bc.ne(kmt), bc.nw(kmt), bc.se(kmt), bc.sw(kmt)]
    at_edge = jnp.zeros(kidx.shape[:1] + kmt.shape, bool)
    for nb in neigh:
        at_edge = at_edge | (kidx == nb[None])
    interior = kidx < kmt[None]
    return (interior & ~at_edge).astype(jnp.float32)


def kappa_eg(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
             umix, vmix_m, hblt=None):
    """Eden & Greatbatch (2008) 3-D diffusivity KAPPA = c L^2 sigma
    (kappa_eg, source/hmix_gm.F90:2463-2659). Returns (km, ny, nx) cm^2/s,
    bounded to [gm_kappa_min_eg, gm_kappa_max_eg]."""
    km = cfg.km
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    dzw = jnp.reshape(grid.vgrid.dzw[1:km + 1], (km, 1, 1))
    dzwr = jnp.reshape(grid.vgrid.dzwr[1:km + 1], (km, 1, 1))

    work3 = _displaced_density_diff(cfg, grid, ts_range, tmix)
    below = kidx < grid.KMT[None]
    n2 = jnp.where(below, -const.GRAV * work3 * dzwr, 0.0)

    du2 = ((umix - jnp.concatenate([umix[1:], umix[-1:]], axis=0)) ** 2
           + (vmix_m - jnp.concatenate([vmix_m[1:], vmix_m[-1:]],
                                       axis=0)) ** 2)
    du2_t = ugrid_to_tgrid(du2, bc)
    ri = jnp.where(below, dzw ** 2 / (du2_t + EPS2) * n2, 0.0)

    # first-baroclinic wave speed, Chelton et al. (1998) (:2580-2596):
    # sum sqrt(N^2_k) dzw_k over k < KMT, plus the k=1 surface half-layer
    # and the bottom half-layer using N^2 at KMT-1
    sqn = jnp.sqrt(jnp.maximum(n2, 0.0))
    dzw0 = grid.vgrid.dzw[0]
    c_rossby = jnp.where(grid.KMT > 1, sqn[0] * dzw0, 0.0)
    c_rossby = c_rossby + jnp.sum(jnp.where(below, sqn * dzw, 0.0), axis=0)
    sqn_km1 = jnp.concatenate([sqn[:1], sqn[:-1]], axis=0)
    at_bot = (kidx == grid.KMT[None]) & (kidx > 1)
    c_rossby = c_rossby + jnp.sum(
        jnp.where(at_bot, sqn_km1 * dzw, 0.0), axis=0)
    c_rossby = c_rossby / jnp.pi

    btp = _btp(grid, bc)
    l_rossby = jnp.minimum(c_rossby / (jnp.abs(grid.FCORT) + EPS),
                           jnp.sqrt(c_rossby / (2.0 * btp)))

    inv_t = jnp.maximum(jnp.abs(grid.FCORT),
                        jnp.sqrt(c_rossby * 2.0 * btp))
    sigma = (_sigma_topo_mask(grid, bc, km) * inv_t[None]
             / jnp.sqrt(ri + cfg.gm_gamma_eg))
    sigma = jnp.where(below, sigma, 0.0)

    lscale = jnp.minimum(l_rossby[None], sigma / btp[None])
    kappa = cfg.gm_const_eg * sigma * lscale ** 2

    # within the surface diabatic layer use the below-layer value (:2640-2648)
    zw = np.asarray(grid.vgrid.zw)
    bl = hblt if hblt is not None else jnp.full_like(grid.FCORT,
                                                     float(zw[0]))
    for k in range(km - 2, -1, -1):
        kappa = kappa.at[k].set(
            jnp.where(zw[k] <= bl, kappa[k + 1], kappa[k]))
    return jnp.clip(kappa, cfg.gm_kappa_min_eg, cfg.gm_kappa_max_eg)


def kappa_fields(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
                 umix=None, vmix_m=None, hblt=None, sdl=None):
    """(kappa_isop, kappa_thic) diffusivities, broadcastable to (km, ny, nx)
    (KAPPA_ISOP/KAPPA_THIC assembly, source/hmix_gm.F90:1345-1399), the
    'cancellation' flag (equal isop/thic diffusivities, :970-987), and
    KAPPA_VERTICAL (the depth/bfre vertical profile, 1.0 otherwise).
    ``sdl`` is the surface-diabatic-layer depth for the bfre profile."""
    km = cfg.km

    def depth_profile():
        zt = jnp.asarray(grid.vgrid.zt)
        prof = (cfg.gm_kappa_depth_1 + cfg.gm_kappa_depth_2
                * jnp.exp(-zt / cfg.gm_kappa_depth_scale))
        return jnp.reshape(prof, (km, 1, 1))

    # KAPPA_VERTICAL: depth profile for 'depth' (init_gm :866-873), the
    # normalized N^2 profile for 'bfre' (:1309-1319), 1 otherwise
    kinds = (cfg.gm_kappa_isop_type, cfg.gm_kappa_thic_type)
    if "bfre" in kinds:
        if sdl is None:
            sdl = jnp.full_like(grid.FCORT, float(np.asarray(grid.vgrid.zw)[0]))
        kappa_vert = kappa_vertical_bfre(cfg, grid, ts_range, tmix, sdl)
    elif "depth" in kinds:
        kappa_vert = jnp.broadcast_to(depth_profile(),
                                      (km,) + grid.FCORT.shape)
    else:
        kappa_vert = jnp.ones((1, 1, 1), dtype=tmix.dtype)

    def build(ktype, ah, deep):
        if ktype == "const":
            return jnp.asarray(ah)
        if ktype == "depth":
            return ah * kappa_vert
        if ktype == "bfre":
            # KAPPA_LATERAL stays at its init value ah for pure bfre
            # (init_gm :859, assembly :1353-1359 / :1381-1387)
            return ah * jnp.maximum(kappa_vert, deep)
        if ktype == "vmhs":
            if umix is None:
                raise ValueError("vmhs kappa needs mix-time velocities")
            return kappa_vmhs(cfg, grid, bc, ts_range, tmix, umix,
                              vmix_m)[None]
        if ktype == "eg":
            if umix is None:
                raise ValueError("eg kappa needs mix-time velocities")
            return kappa_eg(cfg, grid, bc, ts_range, tmix, umix, vmix_m,
                            hblt)
        raise NotImplementedError(f"gm kappa type {ktype}")

    kisop = build(cfg.gm_kappa_isop_type, cfg.gm_ah, cfg.gm_kappa_isop_deep)
    if cfg.gm_kappa_thic_type == "eg" and cfg.gm_kappa_isop_type == "eg":
        kthic = kisop  # KAPPA_THIC = KAPPA_ISOP (:1389)
    else:
        kthic = build(cfg.gm_kappa_thic_type, cfg.gm_ah_bolus,
                      cfg.gm_kappa_thic_deep)

    same_type = cfg.gm_kappa_isop_type == cfg.gm_kappa_thic_type
    if same_type and cfg.gm_kappa_isop_type in ("const", "depth", "bfre"):
        # the reference's cancellation test ignores the kappa_*_deep floors
        # (init_gm :970-983)
        cancellation = cfg.gm_ah == cfg.gm_ah_bolus
    else:
        cancellation = same_type  # vmhs/eg ignore ah/ah_bolus scaling
    if cfg.gm_transition_layer:
        cancellation = False      # always (:985-987)
    return kisop, kthic, cancellation, kappa_vert


def _aniso_factors(cfg: ModelConfig, grid: Grid, bc: BC, umix, vmix_m):
    """Directional diffusivity factors (ax, ay) for anisotropic GM
    (source/hmix_gm_aniso.F90, Smith & Gent 2004). The full scheme carries
    a 2x2 kappa tensor; this rebuild keeps its diagonal in the rotated
    frame — kappa_x = kmaj cos^2(theta) + kmin sin^2(theta) and the
    complement for kappa_y, theta the local flow direction ('flow') or zero
    ('grid') — which preserves the scheme's intent (suppress cross-stream
    eddy transport) without the cross-term quarter-cell bookkeeping."""
    r = cfg.gm_aniso_ratio
    if cfg.gm_aniso == "grid":
        return 1.0, r
    if cfg.gm_aniso == "flow":
        if umix is None or vmix_m is None:
            raise ValueError("gm_aniso='flow' needs mix-time velocities")
        ut = ugrid_to_tgrid(umix, bc)
        vt = ugrid_to_tgrid(vmix_m, bc)
        u2, v2 = ut ** 2, vt ** 2
        s = u2 + v2 + EPS
        cos2, sin2 = u2 / s, v2 / s
        return cos2 + r * sin2, sin2 + r * cos2     # (km, ny, nx) each
    raise NotImplementedError(f"gm_aniso {cfg.gm_aniso}")


def hdifft_gm(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, tmix,
              hblt: Optional[jnp.ndarray] = None,
              umix=None, vmix_m=None) -> GMOut:
    """GM/Redi tracer tendency + VDC_GM (hdifft_gm,
    source/hmix_gm.F90:1102-2219); kappa per cfg.gm_kappa_*_type,
    optionally anisotropic (cfg.gm_aniso, hmix_gm_aniso.F90)."""
    km = cfg.km
    dz = jnp.reshape(grid.vgrid.dz, (km, 1, 1))
    dzr = jnp.reshape(grid.vgrid.dzr, (km, 1, 1))
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1

    tx, ty, tz, slx, sly = _slopes(cfg, grid, bc, ts_range, tmix)
    sla = _sla(cfg, grid, slx, sly)

    # transition-layer geometry (hdifft_gm :1221-1247): the diabatic depth
    # is the smoothed KPP boundary-layer depth (smooth_hblt SMOOTH_OUT
    # path, :1227-1228) or the first layer
    tlt = None
    if cfg.gm_transition_layer:
        if cfg.gm_aniso is not None:
            raise NotImplementedError(
                "gm_aniso with the transition layer is not supported "
                "(the reference's aniso GM is a separate scheme)")
        if hblt is not None:
            from pop2_tpu import kpp as kpp_mod
            dd, _ = kpp_mod.smooth_hblt(cfg, grid, bc, hblt)
        else:
            dd = jnp.full_like(grid.FCORT, float(np.asarray(grid.vgrid.zw)[0]))
        tlt = transition_layer(cfg, grid, dd, sla, _rossby_radius(grid))

    bl_depth = (hblt[None, None] if hblt is not None
                else jnp.full((1, 1) + grid.TAREA.shape, grid.vgrid.zw[0]))
    tap_isop, tap_thic, taper1, taper2 = _tapers(cfg, grid, sla, bl_depth,
                                                 tlt)

    # surface-diabatic-layer depth for the bfre N^2 normalization
    # (:3085-3087)
    if tlt is not None:
        sdl = tlt.interior_depth
    elif hblt is not None:
        sdl = hblt
    else:
        sdl = None
    kappa_isop, kappa_thic, kappa_equal, kappa_vert = kappa_fields(
        cfg, grid, bc, ts_range, tmix, umix, vmix_m, hblt, sdl=sdl)
    kisop = tap_isop * kappa_isop         # (half, km, ny, nx)
    kthic = tap_thic * kappa_thic
    # boundary conditions: zero in the top quarter of level 1 and the bottom
    # quarter of the deepest cell (source/hmix_gm.F90:1650-1663)
    kisop = kisop.at[0, 0].set(0.0)
    kthic = kthic.at[0, 0].set(0.0)
    at_bottom = (kidx == grid.KMT[None])
    kisop = kisop.at[1].set(jnp.where(at_bottom, 0.0, kisop[1]))
    kthic = kthic.at[1].set(jnp.where(at_bottom, 0.0, kthic[1]))

    # anisotropic GM: direction-dependent diffusivities (hmix_gm_aniso.F90)
    if cfg.gm_aniso is not None:
        ax, ay = _aniso_factors(cfg, grid, bc, umix, vmix_m)
        kisop_x, kisop_y = kisop * ax, kisop * ay
        kthic_x, kthic_y = kthic * ax, kthic * ay
    else:
        kisop_x = kisop_y = kisop
        kthic_x = kthic_y = kthic

    # surface-boundary-layer horizontal diffusion (HOR_DIFF,
    # source/hmix_gm.F90:1603-1632)
    if tlt is not None:
        # the vertical profile below replaces the (1 - taper) weighting
        # (:1603-1612)
        if cfg.gm_use_const_ah_bkg_srfbl:
            hor_diff = jnp.full_like(kisop, cfg.gm_ah_bkg_srfbl)
        else:
            hor_diff = kappa_isop * jnp.ones_like(kisop)
    else:
        zt_above = jnp.concatenate([jnp.zeros_like(grid.vgrid.zt[:1]),
                                    grid.vgrid.zt[:-1]])
        in_bl = jnp.reshape(zt_above, (1, km, 1, 1)) <= bl_depth
        if cfg.gm_use_const_ah_bkg_srfbl:
            hor_diff = jnp.where(
                in_bl, cfg.gm_ah_bkg_srfbl * (1.0 - tap_isop)
                * kappa_vert[None], 0.0)
        else:
            hor_diff = jnp.where(
                in_bl, kappa_isop * (1.0 - tap_isop), 0.0)
        hor_diff = hor_diff.at[0, 0].set(cfg.gm_ah_bkg_srfbl)

    in_mask = kidx <= grid.KMT[None]
    if tlt is not None:
        # merged streamfunction through the diabatic/transition regions
        # (:3441-3738), then vertical profiling of KAPPA_ISOP/HOR_DIFF
        # (:3745-3840)
        sf_slx, sf_sly = merged_streamfunction(cfg, grid, tlt, kthic,
                                               slx, sly)
        kisop, hor_diff = apply_transition_profile(cfg, grid, tlt, kisop,
                                                   hor_diff)
        kisop_x = kisop_y = kisop
    else:
        sf_slx = jnp.where(in_mask[None, None], kthic_x[None] * slx * dz,
                           0.0)
        sf_sly = jnp.where(in_mask[None, None], kthic_y[None] * sly * dz,
                           0.0)

    # bottom-cell horizontal diffusion floor, applied after any transition
    # profiling (source/hmix_gm.F90:1757-1761)
    if cfg.gm_ah_bkg_bottom != 0.0:
        hor_diff = hor_diff.at[1].set(
            jnp.where(at_bottom, cfg.gm_ah_bkg_bottom, hor_diff[1]))

    cancellation = kappa_equal and cfg.gm_slm_r == cfg.gm_slm_b
    gtk, vdc_gm = flux_assembly(cfg, grid, bc, tx, ty, tz, slx, sly,
                                sf_slx, sf_sly, kisop_x, kisop_y,
                                hor_diff, cancellation)
    return GMOut(gtk=gtk, vdc_gm=vdc_gm,
                 kappa_isop=0.5 * (kisop[0] + kisop[1]),
                 kappa_thic=0.5 * (kthic[0] + kthic[1]),
                 hor_diff=0.5 * (hor_diff[0] + hor_diff[1]),
                 dia_depth=tlt.diabatic_depth if tlt is not None else None,
                 tlt_thick=tlt.thickness if tlt is not None else None,
                 int_depth=tlt.interior_depth if tlt is not None else None)


def flux_assembly(cfg: ModelConfig, grid: Grid, bc: BC, tx, ty, tz,
                  slx, sly, sf_slx, sf_sly, kisop_x, kisop_y, hor_diff,
                  cancellation: bool):
    """GM/Redi flux assembly: (GTK, VDC_GM) from the merged per-face
    fields (horizontal + skew + vertical fluxes and their divergence,
    source/hmix_gm.F90:1720-2080)."""
    km = cfg.km
    dz = jnp.reshape(grid.vgrid.dz, (km, 1, 1))
    dzr = jnp.reshape(grid.vgrid.dzr, (km, 1, 1))
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1

    hyx = grid.HTE / grid.HUS
    hxy = grid.HTN / grid.HUW
    hyxw = bc.w(hyx)
    hxys = bc.s(hxy)

    # effective vertical diffusivity VDC_GM (source/hmix_gm.F90:1720-1750);
    # |S|^2 split per direction so the anisotropic kappas weight their own
    # slope components
    km_mask = (kidx < grid.KMT[None]).astype(dz.dtype)
    quad_x = hyx * slx[0, 1] ** 2 + hyxw * slx[1, 1] ** 2
    quad_y = hxy * sly[0, 1] ** 2 + hxys * sly[1, 1] ** 2
    quad_x_kp1 = hyx * slx[0, 0] ** 2 + hyxw * slx[1, 0] ** 2
    quad_y_kp1 = hxy * sly[0, 0] ** 2 + hxys * sly[1, 0] ** 2

    def ktp_kp1(kf):
        return jnp.concatenate([kf[0, 1:], jnp.zeros_like(kf[0, :1])],
                               axis=0)

    kisop_x_ktp_kp1 = ktp_kp1(kisop_x)
    kisop_y_ktp_kp1 = ktp_kp1(kisop_y)

    def dn(q):
        return jnp.concatenate([q[1:], jnp.zeros_like(q[:1])], axis=0)

    dz_kp1 = jnp.concatenate([dz[1:], dz[-1:]], axis=0)
    dzw_k = jnp.reshape(grid.vgrid.dzw[1:km + 1], (km, 1, 1))
    vdc_gm = (dzw_k * km_mask * grid.TAREA_R
              * (dz * 0.25 * (kisop_x[1] * quad_x + kisop_y[1] * quad_y)
                 + dz_kp1 * 0.25 * (kisop_x_ktp_kp1 * dn(quad_x_kp1)
                                    + kisop_y_ktp_kp1 * dn(quad_y_kp1))))
    vdc_gm = vdc_gm.at[-1].set(0.0)

    # horizontal fluxes (source/hmix_gm.F90:1805-1895)
    cx = jnp.where((kidx <= grid.KMT[None]) & (kidx <= grid.KMTE[None]),
                   0.25 * hyx, 0.0)
    cy = jnp.where((kidx <= grid.KMT[None]) & (kidx <= grid.KMTN[None]),
                   0.25 * hxy, 0.0)

    keff_x = kisop_x + hor_diff
    keff_y = kisop_y + hor_diff
    wx = keff_x[0] + keff_x[1]                  # ktp + kbt at (i, j)
    wy = keff_y[0] + keff_y[1]
    work3 = wx + bc.e(wx)                       # east-face effective diff
    work4 = wy + bc.n(wy)

    fx = dz[None] * cx[None] * tx * work3[None]
    fy = dz[None] * cy[None] * ty * work4[None]

    # skew contribution (zero when kappa_isop == kappa_thic and no
    # differential tapering: 'cancellation', source/hmix_gm.F90:970-983;
    # the directional factors scale isop and thic alike, preserving it)
    tz_kp1 = jnp.concatenate([tz[:, 1:], tz[:, -1:]], axis=1)
    if not cancellation:
        w1 = kisop_x[0] * slx[0, 0] * dz - sf_slx[0, 0]
        w2 = kisop_x[1] * slx[0, 1] * dz - sf_slx[0, 1]
        w3 = bc.e(kisop_x[0] * slx[1, 0] * dz - sf_slx[1, 0])
        w4 = bc.e(kisop_x[1] * slx[1, 1] * dz - sf_slx[1, 1])
        fx = fx - cx[None] * (w1[None] * tz + w2[None] * tz_kp1
                              + w3[None] * bc.e(tz)
                              + w4[None] * bc.e(tz_kp1))
        w1 = kisop_y[0] * sly[0, 0] * dz - sf_sly[0, 0]
        w2 = kisop_y[1] * sly[0, 1] * dz - sf_sly[0, 1]
        # tripole: the south-face y-slope's ghost row is the fold of the
        # north-face counterpart with a sign flip (face swap under the
        # 180-degree rotation)
        w3 = bc.n_partner(kisop_y[0] * sly[1, 0] * dz - sf_sly[1, 0],
                          kisop_y[0] * sly[0, 0] * dz - sf_sly[0, 0],
                          "center", "vector")
        w4 = bc.n_partner(kisop_y[1] * sly[1, 1] * dz - sf_sly[1, 1],
                          kisop_y[1] * sly[0, 1] * dz - sf_sly[0, 1],
                          "center", "vector")
        fy = fy - cy[None] * (w1[None] * tz + w2[None] * tz_kp1
                              + w3[None] * bc.n(tz)
                              + w4[None] * bc.n(tz_kp1))

    # vertical flux at the bottom of each cell (source/hmix_gm.F90:1900-2080)
    # split per direction so anisotropic kappas weight their own components
    def cross_x(sl_x, txl):
        return sl_x[0] * hyx * txl + sl_x[1] * hyxw * bc.w(txl)

    def cross_y(sl_y, tyl):
        return sl_y[0] * hxy * tyl + sl_y[1] * hxys * bc.s(tyl)

    tx_kp1 = jnp.concatenate([tx[:, 1:], tx[:, -1:]], axis=1)
    ty_kp1 = jnp.concatenate([ty[:, 1:], ty[:, -1:]], axis=1)
    slx_ktp_kp1 = jnp.concatenate([slx[:, 0, 1:],
                                   jnp.zeros_like(slx[:, 0, :1])], axis=1)
    sly_ktp_kp1 = jnp.concatenate([sly[:, 0, 1:],
                                   jnp.zeros_like(sly[:, 0, :1])], axis=1)
    sf_slx_ktp_kp1 = jnp.concatenate([sf_slx[:, 0, 1:],
                                      jnp.zeros_like(sf_slx[:, 0, :1])],
                                     axis=1)
    sf_sly_ktp_kp1 = jnp.concatenate([sf_sly[:, 0, 1:],
                                      jnp.zeros_like(sf_sly[:, 0, :1])],
                                     axis=1)

    def kcross(kx, ky, sl_x, sl_y, txl, tyl):
        return (kx[None] * cross_x(sl_x, txl)
                + ky[None] * cross_y(sl_y, tyl))

    if cancellation:
        work = (dz[None] * kcross(kisop_x[1], kisop_y[1],
                                  slx[:, 1], sly[:, 1], tx, ty)
                + dz_kp1[None] * kcross(kisop_x_ktp_kp1, kisop_y_ktp_kp1,
                                        slx_ktp_kp1, sly_ktp_kp1,
                                        tx_kp1, ty_kp1))
        fz = -km_mask[None] * 0.5 * work
    else:
        work = (dz[None] * kcross(kisop_x[1], kisop_y[1],
                                  slx[:, 1], sly[:, 1], tx, ty)
                + cross_x(sf_slx[:, 1], tx) + cross_y(sf_sly[:, 1], ty)
                + dz_kp1[None] * kcross(kisop_x_ktp_kp1, kisop_y_ktp_kp1,
                                        slx_ktp_kp1, sly_ktp_kp1,
                                        tx_kp1, ty_kp1)
                + cross_x(sf_slx_ktp_kp1, tx_kp1)
                + cross_y(sf_sly_ktp_kp1, ty_kp1))
        fz = -km_mask[None] * 0.25 * work
    fz = fz.at[:, -1].set(0.0)
    fz_top = jnp.concatenate([jnp.zeros_like(fz[:, :1]), fz[:, :-1]], axis=1)

    gtk = ((fx - bc.w(fx) + fy - bc.s(fy) + fz_top - fz)
           * dzr[None] * grid.TAREA_R)
    gtk = jnp.where(grid.kmask_t[None], gtk, 0.0)
    return gtk, vdc_gm
