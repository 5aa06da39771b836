"""KPP vertical mixing (Large, McWilliams & Doney 1994).

Reference: ``source/vmix_kpp.F90`` (native POP path; CVMix is an external
library whose physics this module reimplements directly):
  * buoydiff       :3509   buoyancy differences (surface-layer-averaged ref)
  * ri_iwmix       :1428   shear-instability + background interior mixing
  * ddmix          :3349   double diffusion (salt fingering + diffusive conv)
  * bldepth        :2002   boundary-layer depth via bulk Richardson number
  * wscale         :3234   Monin-Obukhov similarity velocity scales
  * blmix          :2767   boundary-layer profile + interior matching + ghat
  * smooth_hblt    :3699   1-1-4-1-1 spatial filter of HBLT
  * KPP_SRC        :1277   non-local transport as a tracer source

Design notes:
  * the reference's per-level loops carrying 3-slot ring buffers (bldepth's
    kupper/kup/kdn) become a ``lax.scan`` over levels with the rotation in
    the carry;
  * the O(km x kref) displaced-density evaluations for the surface-layer
    reference become ONE batched EOS call over precomputed (k, m) pairs with
    a host-built sparse weight matrix contracted at full precision;
  * the boundary-layer-depth search is branch-free: the "first level where
    Ri_bulk > Ricr" select folds into the scan carry;
  * per-column gathers at KBL use ``take_along_axis`` over the small km axis.

Interface-indexed arrays (VISC/VDC) use shape (km+2, ny, nx) where index k
matches the reference's 0:km+1 range (k = interface below layer k).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pop2_tpu import constants as const
from pop2_tpu import eos, tidal_mixing
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid
from pop2_tpu.stencil import BC, tgrid_to_ugrid, ugrid_to_tgrid

VONKAR = 0.4
EPS = 1.0e-10
EPS2 = 1.0e-20

# velocity-scale fit constants (source/vmix_kpp.F90:188-194)
ZETA_M = -0.2
ZETA_S = -1.0
C_M = 8.38
C_S = 98.96
A_M = 1.26
A_S = -28.86

EPSSFC = 0.1              # nondimensional surface-layer extent (:109)
RICR = 0.3                # critical bulk Richardson number (:641)
CEKMAN = 0.7              # Ekman depth coefficient (:138)
CMONOB = 1.0              # Monin-Obukhov depth coefficient (:139)
CONCV = 1.7               # min convective factor (:140)
RIINFTY = 0.8             # shear-instability Ri limit (:152)
RRHO0 = 2.55              # double-diffusion density-ratio limit (:162)
DSFMAX = 1.0              # max salt-fingering diffusivity (:163)
CSTAR = 10.0              # nonlocal transport coefficient (:175)

# Python float (not np.float64 scalar), so f32 fields don't promote to f64
VTC = float(np.sqrt(0.2 / C_S / EPSSFC)) / VONKAR ** 2   # (:458)
CG = CSTAR * VONKAR * (C_S * VONKAR * EPSSFC) ** (1.0 / 3.0)  # (:459)


class KPPStatics(NamedTuple):
    """Host-precomputed, grid-dependent constants for the KPP pipeline."""
    bckgrnd_vdc: jnp.ndarray   # background diffusivity, (km,1,1) or
    bckgrnd_vvc: jnp.ndarray   # (1,ny,nx) (kpp_lhoriz_varying_bckgrnd)
    uref_w: jnp.ndarray        # (km, km) surface-layer averaging weights
    pair_k: jnp.ndarray        # (P,) target-level index of each (k,m) pair
    pair_m: jnp.ndarray        # (P,) source-level index
    pair_w: jnp.ndarray        # (km, P) sparse weights: RHOAVG_k = W @ rho_p
    tidal_coef: Optional[jnp.ndarray] = None  # (km, ny, nx) Gamma*q*E*F(z)
    tidal_socn: Optional[jnp.ndarray] = None   # (km, ny, nx) SO kappa floor
    tidal_polzin: Optional[tuple] = None       # PolzinStatics fields
    niw_energy: Optional[jnp.ndarray] = None  # (ny, nx) NIW flux (erg/s/cm^2)


class KPPOut(NamedTuple):
    vdc: jnp.ndarray     # (2, km, ny, nx) tracer diffusivities (T, S class)
    vvc: jnp.ndarray     # (km, ny, nx) viscosity on U points
    ghat_src: jnp.ndarray  # (nt_like 2, km, ny, nx) factor for KPP_SRC:
    #                        class-c VDC*GHAT at interfaces
    hblt: jnp.ndarray    # (ny, nx) boundary layer depth (cm)
    kbl: jnp.ndarray     # (ny, nx) first level below hbl
    hmxl: jnp.ndarray    # (ny, nx) diagnostic mixed layer depth
    # interior-mixing diagnostics for the KVMIX/KVMIX_M/TPOWER tavg
    # fields (vmix_kpp.F90:1826-1868, 1947-1950)
    kvmix: Optional[jnp.ndarray] = None    # (km, ny, nx)
    kvmix_m: Optional[jnp.ndarray] = None  # (km, ny, nx)
    tpower: Optional[jnp.ndarray] = None   # (km, ny, nx) erg/s/cm^3
    hmxl_dr: Optional[jnp.ndarray] = None  # (ny, nx) density-criterion MLD


def background_vdc(cfg: ModelConfig, grid: Grid) -> np.ndarray:
    """Background internal-wave diffusivity (source/vmix_kpp.F90:544-632),
    broadcastable to (km, ny, nx).

    Default: the vertical atan profile vdc1 + vdc2*atan(linv*(zw-dpth)),
    shape (km, 1, 1). With cfg.kpp_lhoriz_varying_bckgrnd (the gx
    production default, namelist_defaults_pop.xml:445-449): the
    depth-independent Jochum (2009) latitude structure — Gregg equatorial
    floor + MacKinnon PSI gaussians at +-28.9 deg + latitude-ramped vdc1 —
    with the Banda Sea boxes overridden to bckgrnd_vdc_ban (:551-590);
    shape (1, ny, nx)."""
    zw = np.asarray(grid.vgrid.zw)
    vdc1, vdc2 = cfg.bckgrnd_vdc, cfg.bckgrnd_vdc2
    if not cfg.kpp_lhoriz_varying_bckgrnd:
        dpth, linv = cfg.bckgrnd_vdc_dpth, cfg.bckgrnd_vdc_linv
        prof = vdc1 + vdc2 * np.arctan(linv * (zw - dpth))
        return prof[:, None, None]
    if vdc2 != 0.0:
        raise ValueError("lhoriz_varying_bckgrnd requires bckgrnd_vdc2 "
                         "== 0 (vmix_kpp.F90:518-521)")
    import pop2_tpu.constants as _c
    latd = np.asarray(grid.TLAT) * _c.RADIAN
    lond = np.asarray(grid.TLON) * _c.RADIAN
    lond = np.where(lond < 0.0, lond + 360.0, lond)
    psis = cfg.bckgrnd_vdc_psim * np.exp(-(0.4 * (latd + 28.9)) ** 2)
    psin = cfg.bckgrnd_vdc_psim * np.exp(-(0.4 * (latd - 28.9)) ** 2)
    vdc = cfg.bckgrnd_vdc_eq + psin + psis
    ramp = np.where(np.abs(latd) <= 10.0, (latd / 10.0) ** 2, 1.0)
    vdc = vdc + vdc1 * ramp
    banda = (((latd < -1.0) & (latd > -4.0)
              & (lond > 103.0) & (lond < 134.0))
             | ((latd <= -4.0) & (latd > -7.0)
                & (lond > 106.0) & (lond < 140.0))
             | ((latd <= -7.0) & (latd > -8.3)
                & (lond > 111.0) & (lond < 142.0)))
    vdc = np.where(banda, cfg.bckgrnd_vdc_ban, vdc)
    return vdc[None]


def build_statics(cfg: ModelConfig, grid: Grid) -> KPPStatics:
    """Precompute background profiles and surface-layer weight matrices
    (source/vmix_kpp.F90:530-641 and the kref logic of :2324-2349,
    :3582-3603)."""
    km = cfg.km
    zt = np.asarray(grid.vgrid.zt)
    zw = np.asarray(grid.vgrid.zw)
    dz = np.asarray(grid.vgrid.dz)

    bck_vdc = background_vdc(cfg, grid)
    bck_vvc = cfg.prandtl * bck_vdc

    # surface-layer averaging weights per target level
    uref_w = np.zeros((km, km))
    uref_w[0, 0] = 1.0
    pair_k, pair_m, weights = [], [], []
    for kl in range(1, km):  # 0-based target level (reference kl = kl0+1)
        surfthick = EPSSFC * zt[kl]
        kref = kl
        for ktmp in range(kl + 1):
            if zw[ktmp] >= surfthick:
                kref = ktmp
                break
        if kref == 0:
            uref_w[kl, 0] = 1.0
            pair_k.append(kl)
            pair_m.append(0)
            weights.append((kl, len(pair_k) - 1, 1.0))
        else:
            w_last = (surfthick - zw[kref - 1]) / surfthick
            uref_w[kl, kref] = w_last
            pair_k.append(kl)
            pair_m.append(kref)
            weights.append((kl, len(pair_k) - 1, w_last))
            for m in range(kref):
                uref_w[kl, m] = dz[m] / surfthick
                pair_k.append(kl)
                pair_m.append(m)
                weights.append((kl, len(pair_k) - 1, dz[m] / surfthick))
    P = len(pair_k)
    pw = np.zeros((km, P))
    for (krow, pcol, w) in weights:
        pw[krow, pcol] = w

    dt = cfg.jnp_dtype
    return KPPStatics(
        bckgrnd_vdc=jnp.asarray(bck_vdc, dt),
        bckgrnd_vvc=jnp.asarray(bck_vvc, dt),
        uref_w=jnp.asarray(uref_w, dt),
        pair_k=jnp.asarray(np.array(pair_k), jnp.int32),
        pair_m=jnp.asarray(np.array(pair_m), jnp.int32),
        pair_w=jnp.asarray(pw, dt),
        tidal_coef=_tidal_coef_field(cfg, grid, dt),
        tidal_socn=(jnp.asarray(
            tidal_mixing.schmittner_socn_floor(cfg, grid), dt)
            if cfg.ltidal_mixing and cfg.ltidal_schmittner_socn else None),
        tidal_polzin=(tuple(tidal_mixing.polzin_statics(cfg, grid))
                      if cfg.ltidal_mixing
                      and cfg.tidal_mixing_method == "polzin" else None),
        niw_energy=_niw_energy_field(cfg, dt),
    )


def _tidal_coef_field(cfg, grid, dt):
    """Static tidal coefficient per method: Jayne/St Laurent F(z) profile
    or the Schmittner subgrid-scale 3-D sum (polzin is per-step)."""
    if not cfg.ltidal_mixing:
        return None
    if cfg.tidal_mixing_method == "schmittner":
        return jnp.asarray(
            tidal_mixing.build_tidal_coef_schmittner(cfg, grid), dt)
    if cfg.tidal_mixing_method == "polzin":
        return None
    return jnp.asarray(tidal_mixing.build_tidal_coef(cfg, grid), dt)


def _niw_energy_field(cfg, dt):
    """External NIW energy flux field, W/m^2 -> erg/s/cm^2
    (niw_mixing.F90:361-365); None when no file is configured (the
    constant cfg.niw_energy_const is used instead)."""
    if not cfg.lniw_mixing or cfg.niw_energy_file is None:
        return None
    raw = np.fromfile(cfg.niw_energy_file, dtype=">f8")
    n = cfg.ny * cfg.nx
    if raw.size < n:
        raise ValueError("niw_energy_file too small")
    return jnp.asarray(1000.0 * raw[:n].reshape(cfg.ny, cfg.nx), dt)


def _rho_full(cfg, T, S, press):
    """Full density with the reference's T >= -2 clamp
    (source/vmix_kpp.F90:3567)."""
    Tc = jnp.maximum(T, -2.0)
    return eos.mwjf_rho(jnp.clip(Tc, -1000.0, 1000.0),
                        jnp.clip(S, 0.0, 1000.0), press)


def buoydiff(cfg: ModelConfig, grid: Grid, st: KPPStatics, trcr):
    """DBLOC (between adjacent levels) and DBSFC (level vs surface-layer
    average), (km, ny, nx) each (source/vmix_kpp.F90:3509-3626)."""
    km = cfg.km
    T, S = trcr[0], trcr[1]
    pz = grid.vgrid.pressz

    # rho of each level's water at its own pressure, and of the level above
    # displaced down one level
    rho_k = _rho_full(cfg, T, S, jnp.reshape(pz, (km, 1, 1)))
    rho_km_disp = _rho_full(cfg, T[:-1], S[:-1],
                            jnp.reshape(pz[1:], (km - 1, 1, 1)))

    # batched displaced densities for the surface-layer average:
    # rho(T_m, S_m, p_k) for all precomputed (k, m) pairs
    Tm = T[st.pair_m]
    Sm = S[st.pair_m]
    pk = pz[st.pair_k][:, None, None]
    rho_pairs = _rho_full(cfg, Tm, Sm, pk)
    rhoavg = jnp.einsum("kp,pyx->kyx", st.pair_w, rho_pairs,
                        precision=jax.lax.Precision.HIGHEST)

    safe = jnp.where(rho_k != 0.0, rho_k, 1.0)
    dbsfc = jnp.where(rho_k != 0.0,
                      const.GRAV * (1.0 - rhoavg / safe), 0.0)
    dbsfc = dbsfc.at[0].set(0.0)

    dbloc_upper = jnp.where(
        rho_k[1:] != 0.0,
        const.GRAV * (1.0 - rho_km_disp / safe[1:]), 0.0)
    # zero at/below column bottom: dbloc(k-1)=0 when k-1 >= KMT
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km - 1, 1, 1), 0) + 1
    dbloc_upper = jnp.where(kidx >= grid.KMT[None], 0.0, dbloc_upper)
    dbloc = jnp.concatenate(
        [dbloc_upper, jnp.zeros_like(dbloc_upper[:1])], axis=0)
    return dbloc, dbsfc


def wscale(sigma, hbl, ustar, bfsfc, want="both"):
    """Turbulent velocity scales (source/vmix_kpp.F90:3234-3342).
    All args broadcastable; returns (wm, ws) (either may be None)."""
    zetah = sigma * hbl * VONKAR * bfsfc
    zeta = zetah / (ustar ** 3 + EPS)
    wm = ws = None
    if want in ("m", "both"):
        wm = jnp.where(
            zeta >= 0.0,
            VONKAR * ustar / (1.0 + 5.0 * zeta),
            jnp.where(zeta >= ZETA_M,
                      VONKAR * ustar
                      * jnp.maximum(1.0 - 16.0 * zeta, 0.0) ** 0.25,
                      VONKAR * jnp.maximum(
                          A_M * ustar ** 3 - C_M * zetah, 0.0)
                      ** (1.0 / 3.0)))
    if want in ("s", "both"):
        ws = jnp.where(
            zeta >= 0.0,
            VONKAR * ustar / (1.0 + 5.0 * zeta),
            jnp.where(zeta >= ZETA_S,
                      VONKAR * ustar
                      * jnp.sqrt(jnp.maximum(1.0 - 16.0 * zeta, 0.0)),
                      VONKAR * jnp.maximum(
                          A_S * ustar ** 3 - C_S * zetah, 0.0)
                      ** (1.0 / 3.0)))
    return wm, ws


def ri_iwmix(cfg: ModelConfig, grid: Grid, bc: BC, st: KPPStatics,
             dbloc, umix, vmix_, tidal_lnc=None, want_kvmix=False):
    """Interior mixing: background + shear instability
    (source/vmix_kpp.F90:1428-1995, non-tidal path).
    Returns (visc, vdc_s) as (km+2, ny, nx) interface arrays (index k =
    reference k; 0 and km+1 are zero-padding for blmix); with
    ``want_kvmix`` also the KVMIX/KVMIX_M diagnostics (tidal+background
    interior diffusivity/viscosity, :1826-1868) as (km, ny, nx)."""
    km = cfg.km
    dzw = grid.vgrid.dzw  # (km+1,), dzw[k] = zgrid(k)-zgrid(k+1), 1-based k

    du = umix - jnp.concatenate([umix[1:], umix[-1:]], axis=0)
    dv = vmix_ - jnp.concatenate([vmix_[1:], vmix_[-1:]], axis=0)
    vshear_u = du ** 2 + dv ** 2
    vshear = ugrid_to_tgrid(vshear_u, bc)
    vshear = vshear.at[-1].set(0.0)

    ri_loc = dbloc * jnp.reshape(dzw[1:km + 1], (km, 1, 1)) / (vshear + EPS)

    # carry last-ocean-level value downward (source/vmix_kpp.F90:1567)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    in_ocean = kidx <= grid.KMT[None]

    def fill(carry, xs):
        ri_k, ok = xs
        out = jnp.where(ok, ri_k, carry)
        return out, out

    _, ri_filled = jax.lax.scan(fill, jnp.zeros_like(ri_loc[0]),
                                (ri_loc, in_ocean))

    # 1-2-1 vertical smoothing where KMT >= 3 (:1579-1603)
    smooth_ok = (grid.KMT >= 3)[None]
    ri = ri_filled
    for _ in range(cfg.num_v_smooth_ri):
        ri_up = jnp.concatenate([ri[:1], ri[:-1]], axis=0)
        ri_dn = jnp.concatenate([ri[1:], ri[-1:]], axis=0)
        ri = jnp.where(smooth_ok,
                       0.25 * ri_up + 0.5 * ri + 0.25 * ri_dn, ri)

    fri = jnp.minimum(jnp.maximum(ri, 0.0) / RIINFTY, 1.0)
    fshear = cfg.rich_mix * (1.0 - fri * fri) ** 3

    bck_vdc = st.bckgrnd_vdc        # (km,1,1) or (1,ny,nx), see
    bck_vvc = st.bckgrnd_vvc        # background_vdc
    if cfg.ltidal_mixing and (st.tidal_coef is not None
                              or st.tidal_polzin is not None):
        # kappa_tidal capped at tidal_mix_max (vmix_kpp.F90:1773-1835,
        # tidal_compute_diff :3046-3140); the interface spacing uses DZT
        # under partial bottom cells (:1775-1780)
        from pop2_tpu.grid import thickness_t
        dzt = thickness_t(cfg, grid)
        dzt_kp1 = jnp.concatenate([dzt[1:], dzt[-1:]], axis=0)
        n2 = dbloc / (0.5 * (dzt + dzt_kp1))
        # 18.6-yr lunar nodal cycle: the tidal energy (and so the
        # diffusivity) is modulated by the nodal factor (tidal_mixing.py
        # lunar_nodal_modulation; tidal_mixing.F90 ltidal_lunar_cycle)
        lnc = 1.0 if tidal_lnc is None else tidal_lnc
        if cfg.tidal_mixing_method == "polzin":
            # Polzin/Melet stratification-shaped profile (per step)
            tdiff = lnc * tidal_mixing.polzin_diff(
                cfg, grid, tidal_mixing.PolzinStatics(*st.tidal_polzin), n2)
        else:
            # Jayne and Schmittner: static coefficient / N^2
            tdiff = jnp.where(n2 > 0.0,
                              lnc * st.tidal_coef / (n2 + EPS), 0.0)
        if st.tidal_socn is not None:
            # Schmittner Southern-Ocean deep floor
            # (source/tidal_mixing.F90:1410-1435)
            tdiff = jnp.maximum(tdiff, st.tidal_socn)
        tdiff = jnp.minimum(tdiff, cfg.tidal_mix_max)
        pr = cfg.prandtl
        visc_k = pr * jnp.minimum(bck_vvc / pr + tdiff, cfg.tidal_mix_max) \
            + (fshear if cfg.kpp_lrich else 0.0)
        vdc_k = jnp.minimum(bck_vdc + tdiff, cfg.tidal_mix_max) \
            + (fshear if cfg.kpp_lrich else 0.0)
        # KVMIX/KVMIX_M diagnostics: interior diffusivity/viscosity
        # before the shear-instability term (:1826-1841)
        kvmix = jnp.minimum(bck_vdc + tdiff, cfg.tidal_mix_max) \
            * jnp.ones_like(visc_k)
        kvmix_m = pr * jnp.minimum(bck_vvc / pr + tdiff,
                                   cfg.tidal_mix_max) \
            * jnp.ones_like(visc_k)
    else:
        visc_k = bck_vvc + (fshear if cfg.kpp_lrich else 0.0)
        vdc_k = bck_vdc + (fshear if cfg.kpp_lrich else 0.0)
        # background-only diagnostics (:1861-1868)
        kvmix = bck_vdc * jnp.ones_like(visc_k)
        kvmix_m = bck_vvc * jnp.ones_like(visc_k)

    # zero at/below sea floor (:1913-1921)
    below = kidx >= grid.KMT[None]
    visc_k = jnp.where(below, 0.0, visc_k)
    vdc_k = jnp.where(below, 0.0, vdc_k)
    # KVMIX is set only for k < km (:1829-1842)
    kvmix = kvmix.at[-1].set(0.0)
    kvmix_m = kvmix_m.at[-1].set(0.0)

    zpad = jnp.zeros_like(visc_k[:1])
    visc = jnp.concatenate([zpad, visc_k, zpad], axis=0)
    vdc = jnp.concatenate([zpad, vdc_k, zpad], axis=0)
    if want_kvmix:
        return visc, vdc, kvmix, kvmix_m
    return visc, vdc


def ddmix(cfg: ModelConfig, grid: Grid, trcr, vdc_t, vdc_s):
    """Double-diffusive mixing (source/vmix_kpp.F90:3459-3497, native path).
    vdc_t/vdc_s are (km+2,...) interface arrays; returns updated pair."""
    km = cfg.km
    T, S = trcr[0], trcr[1]
    pz = grid.vgrid.pressz
    pcol = jnp.reshape(pz, (km, 1, 1))
    _, talpha, sbeta = eos.mwjf_rho(
        jnp.clip(jnp.maximum(T, -2.0), -1000.0, 1000.0),
        jnp.clip(S, 0.0, 1000.0), pcol,
        want_drhodt=True, want_drhods=True)
    t_dn = jnp.concatenate([T[1:], T[-1:]], axis=0)
    s_dn = jnp.concatenate([S[1:], S[-1:]], axis=0)
    ta_dn = jnp.concatenate([talpha[1:], talpha[-1:]], axis=0)
    sb_dn = jnp.concatenate([sbeta[1:], sbeta[-1:]], axis=0)
    alphadt = -0.5 * (talpha + ta_dn) * (T - t_dn)
    betads = 0.5 * (sbeta + sb_dn) * (S - s_dn)
    alphadt = alphadt.at[-1].set(0.0)
    betads = betads.at[-1].set(0.0)

    # salt fingering
    finger = (alphadt > betads) & (betads > 0.0)
    rrho = jnp.minimum(alphadt / jnp.where(betads != 0.0, betads, 1.0),
                       RRHO0)
    diffdd_f = DSFMAX * (1.0 - (rrho - 1.0) / (RRHO0 - 1.0)) ** 3
    add_t = jnp.where(finger, 0.7 * diffdd_f, 0.0)
    add_s = jnp.where(finger, diffdd_f, 0.0)

    # diffusive convection
    dconv = (alphadt < 0.0) & (betads < 0.0) & (alphadt > betads)
    rrho_c = jnp.where(dconv, alphadt / jnp.where(betads != 0.0, betads,
                                                  1.0), 0.0)
    diffdd_c = jnp.where(
        dconv,
        1.5e-2 * 0.909 * jnp.exp(4.6 * jnp.exp(
            -0.54 * (1.0 / jnp.where(rrho_c != 0.0, rrho_c, 1.0) - 1.0))),
        0.0)
    prandtl = jnp.where(dconv, 0.15 * rrho_c, 0.0)
    prandtl = jnp.where(rrho_c > 0.5, (1.85 - 0.85 / jnp.where(
        rrho_c != 0.0, rrho_c, 1.0)) * rrho_c, prandtl)
    add_t = add_t + diffdd_c
    add_s = add_s + prandtl * diffdd_c

    vdc_t = vdc_t.at[1:km + 1].add(add_t)
    vdc_s = vdc_s.at[1:km + 1].add(add_s)
    return vdc_t, vdc_s


def _radiative_bfsfc(cfg: ModelConfig, bo, bosol, depth_cm, chl_co=None):
    """BFSFC = BO + radiative contribution absorbed above ``depth_cm``
    (source/vmix_kpp.F90:2387-2416, 2706-2751). ``depth_cm`` broadcasts
    against ``bo``; sw_absorption 'none' maps to the reference's
    'top-layer' (all shortwave absorbed above any depth)."""
    from pop2_tpu import sw_absorption as sw_mod
    if cfg.sw_absorption == "jerlov":
        absorb = sw_mod.sw_absorb_frac_jnp(depth_cm, cfg.jerlov_water_type)
        return bo + bosol * (1.0 - absorb)
    if cfg.sw_absorption == "chlorophyll":
        trans = sw_mod.chl_trans_at(chl_co, depth_cm)
        return bo + bosol * (1.0 - trans)
    return bo + bosol  # 'top-layer'


def bldepth(cfg: ModelConfig, grid: Grid, bc: BC, st: KPPStatics,
            dbloc, dbsfc, trcr, umix, vmix_, stf, shf_qsw, smft,
            chl=None):
    """Boundary-layer depth from the bulk Richardson number
    (source/vmix_kpp.F90:2002-2760), incl. the ``lshort_wave`` radiative
    buoyancy contribution (:2387-2416) and the ``lcheckekmo``
    Ekman/Monin-Obukhov depth limits (:2425-2453, 2676-2689).

    Returns (hblt, ustar, bfsfc, stable, kbl)."""
    km = cfg.km
    zt = grid.vgrid.zt
    dzw = grid.vgrid.dzw

    ustar = jnp.maximum(jnp.sqrt(jnp.sqrt(smft[0] ** 2 + smft[1] ** 2)), EPS)

    # surface buoyancy forcing (:2156-2179)
    rho1, talpha, sbeta = eos.mwjf_rho(
        jnp.clip(jnp.maximum(trcr[0, 0], -2.0), -1000.0, 1000.0),
        jnp.clip(trcr[1, 0], 0.0, 1000.0), grid.vgrid.pressz[0],
        want_drhodt=True, want_drhods=True)
    safe1 = jnp.where(rho1 != 0.0, rho1, 1.0)
    bo = jnp.where(rho1 != 0.0, const.GRAV
                   * (-talpha * stf[0] - sbeta * stf[1]) / safe1, 0.0)
    bosol = jnp.where(rho1 != 0.0,
                      -const.GRAV * talpha * shf_qsw / safe1, 0.0)

    chl_co = None
    if cfg.kpp_lshort_wave and cfg.sw_absorption == "chlorophyll":
        from pop2_tpu import sw_absorption as sw_mod
        if chl is None:
            chl = jnp.full_like(bo, cfg.chl_const)
        chl_co = sw_mod.chl_coeffs(chl)

    # per-level surface buoyancy forcing at the level-center depths; with
    # lshort_wave the radiative part absorbed above zt(kl) is included
    # (:2387-2416); without it BFSFC = BO at every level (:2414-2416)
    ztc = jnp.reshape(zt, (km, 1, 1))
    if cfg.kpp_lshort_wave:
        bfsfc_all = _radiative_bfsfc(cfg, bo[None], bosol[None], ztc, chl_co)
    else:
        bfsfc_all = jnp.broadcast_to(bo[None], (km,) + bo.shape)
    stable_all = (bfsfc_all >= 0.0).astype(bfsfc_all.dtype)
    bfsfc_all = bfsfc_all + stable_all * EPS
    bfsfc = bfsfc_all[0]
    stable = stable_all[0]

    # surface-layer-averaged reference velocities for every target level:
    # one contraction with the host-built weights (:2334-2349); HIGHEST
    # keeps float32 out of reduced-precision (TF32) matrix units
    uref = jnp.einsum("lm,myx->lyx", st.uref_w, umix,
                      precision=jax.lax.Precision.HIGHEST)
    vref = jnp.einsum("lm,myx->lyx", st.uref_w, vmix_,
                      precision=jax.lax.Precision.HIGHEST)
    work = (uref - umix) ** 2 + (vref - vmix_) ** 2
    # T point takes the max of the 4 surrounding U values (:2371-2378)
    vshear_all = jnp.maximum(
        jnp.maximum(work, bc.w(work)),
        jnp.maximum(bc.s(work), bc.sw(work)))

    # turbulent velocity scale at sigma = epssfc for each level
    zkl_all = jnp.reshape(zt, (km, 1, 1))
    _, ws_all = wscale(EPSSFC, zkl_all, ustar[None], bfsfc_all, want="s")

    b_frq = jnp.sqrt(0.5 * (dbloc + jnp.abs(dbloc) + EPS2)
                     / jnp.reshape(dzw[1:km + 1], (km, 1, 1)))
    wm_all = (zkl_all * ws_all * b_frq
              * ((VTC / RICR) * jnp.maximum(2.1 - 200.0 * b_frq, CONCV)))

    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    zref_all = -EPSSFC * zkl_all / 2.0
    worknum = jnp.where(kidx <= grid.KMT[None],
                        (zref_all + zkl_all) * dbsfc, 0.0)
    ri_bulk_all = worknum / (vshear_all + wm_all + EPS)

    # scan kl = 2..km finding the first level with Ri_bulk > Ricr, with the
    # quadratic interpolation of the crossing depth (:2602-2638)
    kmt = grid.KMT
    kbl0 = jnp.where(kmt > 1, kmt, 1)
    hblt0 = jnp.where(kmt > 1, zt[jnp.maximum(kmt - 1, 0)], zt[0])
    hblt0 = jnp.where(kmt > 0, hblt0, 0.0)

    zt_np = zt  # device array; per-step scalars via dynamic indexing in scan

    def body(carry, kl):
        ri_upper, ri_up, z_upper, z_up, hblt, kbl, found = carry
        ri_dn = ri_bulk_all[kl - 1]      # kl is 1-based level number
        zkl = zt_np[kl - 1]
        ricr = RICR
        not_found = ~found
        crossing = not_found & (ri_dn > ricr) & (kl <= kmt)

        slope_up = (ri_upper - ri_up) / (z_up - z_upper)
        a_co = (ri_dn - ri_up - slope_up * (zkl + z_up)) / (z_up + zkl) ** 2
        b_co = slope_up + 2.0 * a_co * z_up
        c_co = ri_up + z_up * (a_co * z_up + slope_up) - ricr
        sqrt_arg = b_co ** 2 - 4.0 * a_co * c_co
        lin = (-z_up + (z_up + zkl) * (ricr - ri_up)
               / jnp.where(ri_dn != ri_up, ri_dn - ri_up, EPS))
        use_lin = ((jnp.abs(b_co) > EPS)
                   & (jnp.abs(a_co) / jnp.maximum(jnp.abs(b_co), EPS) <= EPS)
                   ) | (sqrt_arg <= 0.0)
        quad = (-b_co + jnp.sqrt(jnp.maximum(sqrt_arg, 0.0))) / (
            2.0 * jnp.where(a_co != 0.0, a_co, EPS))
        hnew = jnp.where(use_lin, lin, quad)

        hblt = jnp.where(crossing, hnew, hblt)
        kbl = jnp.where(crossing, kl, kbl)
        found = found | crossing
        return ((ri_up, ri_dn, z_up, -zkl, hblt, kbl, found), None)

    zeros = jnp.zeros_like(hblt0)
    carry0 = (zeros, zeros, jnp.asarray(0.0, hblt0.dtype),
              -zt[0], hblt0, kbl0, jnp.zeros_like(kmt, bool))
    (ri_upper, ri_up, z_upper, z_up, hblt, kbl, found), _ = jax.lax.scan(
        body, carry0, jnp.arange(2, km + 1, dtype=kbl0.dtype))

    # Ekman / Monin-Obukhov depth limits (lcheckekmo, :2425-2453 in-loop,
    # :2676-2689 application)
    if cfg.kpp_lcheckekmo:
        bottom = zt[km - 1]
        ustar3 = ustar ** 3
        # initialization at z_up = zgrid(1) (:2239-2266) using the surface
        # level's radiative BFSFC
        work0 = (stable_all[0] * CMONOB * ustar3 / VONKAR / bfsfc_all[0]
                 + (1.0 - stable_all[0]) * bottom)
        hm_up0 = jnp.where(work0 <= zt[0], zt[0] + EPS, work0)
        hek0 = jnp.full_like(hblt, bottom + EPS)
        hlim0 = jnp.full_like(hblt, bottom + EPS)
        fcort_abs = jnp.abs(grid.FCORT)

        def ekmo_body(carry, xs):
            hm_up, hek, hlim = carry
            bfs, stb, zkl, zupd = xs  # zupd = depth of level kl-1
            hek = jnp.where((stb > 0.5) & (hek >= bottom),
                            jnp.maximum(zkl, CEKMAN * ustar
                                        / (fcort_abs + EPS)), hek)
            hm_dn = (stb * CMONOB * ustar3 / VONKAR / bfs
                     + (1.0 - stb) * bottom)
            cond = (hm_dn <= zkl) & (hm_up > zupd)
            w = (hm_dn - hm_up) / (zkl - zupd)
            hlim = jnp.where(cond, (hm_dn - w * zkl) / (1.0 - w), hlim)
            return (hm_dn, hek, hlim), None

        (_, hekman, hlimit), _ = jax.lax.scan(
            ekmo_body, (hm_up0, hek0, hlim0),
            (bfsfc_all[1:], stable_all[1:], zt[1:], zt[:-1]))

        hlimit = jnp.minimum(hlimit, hekman)
        # apply the limit (:2676-2689). The reference's where-loop over kl
        # re-reads the updated HBLT, so only the first satisfying kl fires;
        # with ZKL frozen at its km-loop value the bracket degenerates to
        # (zt(1), zt(km)] — transliterated faithfully. KBL is rebuilt from
        # HBLT inside smooth_hblt immediately after, as in the reference.
        applies = ((hlimit < hblt) & (hlimit > zt[0])
                   & (hlimit <= bottom))
        hblt = jnp.where(applies, hlimit, hblt)

    # 1-1-4-1-1 spatial smoothing + bottom clamp + KBL rebuild (:3699-3877)
    hblt, kbl = smooth_hblt(cfg, grid, bc, hblt)

    # correct stability and buoyancy forcing for shortwave absorbed above
    # the final boundary-layer depth (:2706-2751)
    if cfg.kpp_lshort_wave:
        bfsfc = _radiative_bfsfc(cfg, bo, bosol, hblt, chl_co)
        stable = (bfsfc >= 0.0).astype(bfsfc.dtype)
        bfsfc = bfsfc + stable * EPS

    return hblt, ustar, bfsfc, stable, kbl


def smooth_hblt(cfg: ModelConfig, grid: Grid, bc: BC, hblt):
    """Masked 5-point filter of the boundary-layer depth + bottom clamping
    and KBL recomputation (source/vmix_kpp.F90:3797-3877)."""
    km = cfg.km
    zt = grid.vgrid.zt
    ocean = grid.RCALCT > 0.0
    rdt = grid.RCALCT.dtype
    nmask = (bc.n(grid.RCALCT) > 0).astype(rdt)
    smask = (bc.s(grid.RCALCT) > 0).astype(rdt)
    emask = (bc.e(grid.RCALCT) > 0).astype(rdt)
    wmask = (bc.w(grid.RCALCT) > 0).astype(rdt)
    cw = 0.125 * wmask
    ce = 0.125 * emask
    cn = 0.125 * nmask
    cs = 0.125 * smask
    cc = 1.0 - cw - ce - cn - cs
    sm = (cc * hblt + cw * bc.w(hblt) + ce * bc.e(hblt)
          + cs * bc.s(hblt) + cn * bc.n(hblt))
    hblt = jnp.where(ocean, sm, hblt)

    # clamp to the local bottom depth
    zt_bottom = jnp.where(grid.KMT > 0, zt[jnp.maximum(grid.KMT - 1, 0)],
                          zt[0])
    hblt = jnp.minimum(hblt, zt_bottom)
    hblt = jnp.maximum(hblt, zt[0])

    # rebuild KBL: the level k (>=2) with zt(k-1) < HBLT <= zt(k)
    deeper = (hblt[None] > jnp.reshape(zt, (km, 1, 1))).astype(jnp.int32)
    kbl = jnp.clip(1 + jnp.sum(deeper, axis=0), 2, km)
    kbl = jnp.where(grid.KMT > 0, jnp.minimum(kbl, jnp.maximum(grid.KMT, 2)),
                    kbl)
    return hblt, kbl


def blmix(cfg: ModelConfig, grid: Grid, st: KPPStatics, visc, vdc_t, vdc_s,
          hblt, ustar, bfsfc, stable, kbl):
    """Boundary-layer mixing profile, interior matching, enhanced mixing at
    kbl-1, and the non-local coefficient ghat
    (source/vmix_kpp.F90:2900-3222, native path).

    visc/vdc_* are (km+2, ny, nx) interface arrays (index = reference k).
    Returns updated (visc, vdc_t, vdc_s, ghat) with ghat (km, ny, nx)."""
    km = cfg.km
    zt = grid.vgrid.zt
    dz = grid.vgrid.dz
    dzw = grid.vgrid.dzw
    shp = hblt.shape

    wm_h, ws_h = wscale(EPSSFC, hblt, ustar, bfsfc, want="both")

    # caseA / KN (:2924-2934): caseA = 1 when hbl is above the top interface
    # of cell kbl
    zt_kbl = zt[kbl - 1]
    dz_kbl = dz[kbl - 1]
    casea = (zt_kbl - 0.5 * dz_kbl - hblt >= 0.0).astype(hblt.dtype)
    kn = jnp.where(casea > 0.5, kbl - 1, kbl).astype(jnp.int32)

    # gather interface values around KN; interface arrays are indexed so
    # that reference k = array index (0..km+1), as a one-hot masked
    # reduction: the compare+select+sum fuses into one pass over the
    # column (a take_along_axis gather is the alternative form)
    _kar = jax.lax.broadcasted_iota(jnp.int32, (km + 2, 1, 1), 0)

    def gather(iface, idx):
        oh = (_kar == idx[None]).astype(iface.dtype)
        return jnp.sum(iface * oh, axis=0)

    kn0 = kn  # value in 1..km
    visc_km1 = gather(visc, kn0 - 1)
    visc_k = gather(visc, kn0)
    visc_kp1 = gather(visc, kn0 + 1)
    vdct_km1 = gather(vdc_t, kn0 - 1)
    vdct_k = gather(vdc_t, kn0)
    vdct_kp1 = gather(vdc_t, kn0 + 1)
    vdcs_km1 = gather(vdc_s, kn0 - 1)
    vdcs_k = gather(vdc_s, kn0)
    vdcs_kp1 = gather(vdc_s, kn0 + 1)

    hwide_pad = jnp.concatenate([jnp.asarray([EPS], dz.dtype), dz,
                                 jnp.asarray([EPS], dz.dtype)])
    hw_k = hwide_pad[kn0]       # hwide(kn)
    hw_kp1 = hwide_pad[kn0 + 1]
    zt_kn = zt[kn0 - 1]

    f1 = stable * 5.0 * bfsfc / (ustar ** 4 + EPS)
    delhat = 0.5 * hw_k + zt_kn - hblt
    r = 1.0 - delhat / hw_k

    def match(v_km1, v_k, v_kp1):
        dvdzup = (v_km1 - v_k) / hw_k
        dvdzdn = (v_k - v_kp1) / hw_kp1
        vp = 0.5 * ((1.0 - r) * (dvdzup + jnp.abs(dvdzup))
                    + r * (dvdzdn + jnp.abs(dvdzdn)))
        vh = v_k + vp * delhat
        return vp, vh

    viscp, visch = match(visc_km1, visc_k, visc_kp1)
    diftp, difth = match(vdct_km1, vdct_k, vdct_kp1)
    difsp, difsh = match(vdcs_km1, vdcs_k, vdcs_kp1)

    gat1_m = visch / hblt / (wm_h + EPS)
    dat1_m = jnp.minimum(-viscp / (wm_h + EPS) + f1 * visch, 0.0)
    gat1_s = difsh / hblt / (ws_h + EPS)
    dat1_s = jnp.minimum(-difsp / (ws_h + EPS) + f1 * difsh, 0.0)
    gat1_t = difth / hblt / (ws_h + EPS)
    dat1_t = jnp.minimum(-diftp / (ws_h + EPS) + f1 * difth, 0.0)

    # shape function at every interface (:3073-3109)
    sigma_all = ((jnp.reshape(zt, (km, 1, 1))
                  + 0.5 * jnp.reshape(dz, (km, 1, 1))) / hblt[None])
    f1s = jnp.minimum(sigma_all, EPSSFC)
    wm_all, ws_all = wscale(f1s, hblt[None], ustar[None], bfsfc[None],
                            want="both")

    def blprofile(w, gat1, dat1):
        s = sigma_all
        return (hblt[None] * w * s
                * (1.0 + s * ((s - 2.0)
                              + (3.0 - 2.0 * s) * gat1[None]
                              + (s - 1.0) * dat1[None])))

    blmc_m = blprofile(wm_all, gat1_m, dat1_m)
    blmc_s = blprofile(ws_all, gat1_s, dat1_s)
    blmc_t = blprofile(ws_all, gat1_t, dat1_t)
    ghat = jnp.broadcast_to(
        ((1.0 - stable) * CG / (ws_all * hblt[None] + EPS)),
        (km,) + shp)

    # diffusivities at kbl-1 (:3117-3144)
    zt_pad = jnp.concatenate([jnp.asarray([EPS], zt.dtype), zt])
    sig_km1 = zt_pad[kbl - 1] / hblt
    f1k = jnp.minimum(sig_km1, EPSSFC)
    wm1, ws1 = wscale(f1k, hblt, ustar, bfsfc, want="both")

    def dkm1_of(w, gat1, dat1):
        s = sig_km1
        return (hblt * w * s * (1.0 + s * ((s - 2.0)
                                           + (3.0 - 2.0 * s) * gat1
                                           + (s - 1.0) * dat1)))

    dkm1_m = dkm1_of(wm1, gat1_m, dat1_m)
    dkm1_s = dkm1_of(ws1, gat1_s, dat1_s)
    dkm1_t = dkm1_of(ws1, gat1_t, dat1_t)

    # enhanced mixing at k = kbl-1 (:3153-3198)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    at_enh = kidx == (kbl - 1)[None]
    delhat_e = ((hblt[None] - jnp.reshape(zt, (km, 1, 1)))
                / jnp.reshape(dzw[1:km + 1], (km, 1, 1)))

    def enhance(blmc, dkm1, v_iface):
        enh = ((1.0 - delhat_e) * v_iface
               + delhat_e * ((1.0 - delhat_e) ** 2 * dkm1[None]
                             + delhat_e ** 2 * (casea[None] * v_iface
                                                + (1.0 - casea[None])
                                                * blmc)))
        return jnp.where(at_enh, enh, blmc)

    blmc_m = enhance(blmc_m, dkm1_m, visc[1:km + 1])
    blmc_s = enhance(blmc_s, dkm1_s, vdc_s[1:km + 1])
    blmc_t = enhance(blmc_t, dkm1_t, vdc_t[1:km + 1])
    ghat = jnp.where(at_enh, (1.0 - casea[None]) * ghat, ghat)

    # combine boundary layer with interior (:3207-3221)
    in_bl = kidx < kbl[None]
    visc = visc.at[1:km + 1].set(
        jnp.where(in_bl, blmc_m, visc[1:km + 1]))
    vdc_s = vdc_s.at[1:km + 1].set(
        jnp.where(in_bl, blmc_s, vdc_s[1:km + 1]))
    vdc_t = vdc_t.at[1:km + 1].set(
        jnp.where(in_bl, blmc_t, vdc_t[1:km + 1]))
    ghat = jnp.where(in_bl, ghat, 0.0)
    return visc, vdc_t, vdc_s, ghat


def hmxl_dr_diag(cfg: ModelConfig, grid: Grid, trcr):
    """Diagnostic mixed-layer depth from the fixed density-threshold
    criterion (offset 0.03 kg/m^3 = 3e-5 g/cm^3), linear interpolation
    between the bracketing level centers (HMXL_DR, QL 150526,
    source/vmix_kpp.F90:1385-1417)."""
    km = cfg.km
    zt = grid.vgrid.zt
    p1 = grid.vgrid.pressz[0]

    T = jnp.where(trcr[0] < -2.0, -2.0, trcr[0])
    # potential density: every level displaced to the level-1 pressure
    rho = eos.mwjf_rho(jnp.clip(T, -1000.0, 1000.0),
                       jnp.clip(trcr[1], 0.0, 1000.0), p1)
    target = rho[0] + 3.0e-5

    rho_k = rho[:-1]                      # levels 1..km-1
    rho_kp1 = rho[1:]
    cond = (target > rho_k) & (target <= rho_kp1)     # (km-1, ny, nx)
    found = jnp.any(cond, axis=0)
    k0 = jnp.argmax(cond, axis=0)                     # first bracketing k
    ztk = jnp.asarray(zt)[k0]
    ztk1 = jnp.asarray(zt)[k0 + 1]
    # one-hot masked reduction (see blmix.gather)
    kar = jax.lax.broadcasted_iota(jnp.int32, (km - 1, 1, 1), 0)
    oh = (kar == k0[None]).astype(rho_k.dtype)
    r_k = jnp.sum(rho_k * oh, axis=0)
    r_k1 = jnp.sum(rho_kp1 * oh, axis=0)
    interp = ztk + (target - r_k) * (ztk1 - ztk) / (r_k1 - r_k + EPS)

    out = jnp.where(found, interp, 0.0)
    out = jnp.where(grid.KMT == 1, zt[0], out)
    return out


def hmxl_diag(cfg: ModelConfig, grid: Grid, dbsfc):
    """Diagnostic mixed-layer depth from the max buoyancy-gradient criterion
    (source/vmix_kpp.F90:1319-1383), vectorized with scans."""
    km = cfg.km
    zt = grid.vgrid.zt
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    in_ocean = kidx <= grid.KMT[None]
    ztc = jnp.reshape(zt, (km, 1, 1))

    # pass 1: ustar = max_k dbsfc_k/zt_k; hmxl = deepest ocean zt
    ratio = jnp.where(in_ocean[1:], dbsfc[1:] / ztc[1:], 0.0)
    ustar = jnp.maximum(jnp.max(ratio, axis=0), 0.0)
    hmxl = jnp.where(grid.KMT == 1, zt[0],
                     jnp.where(grid.KMT > 1,
                               zt[jnp.maximum(grid.KMT - 1, 0)], 0.0))

    # pass 2: first k where the local gradient reaches the max ratio
    grad = (dbsfc[1:] - dbsfc[:-1]) / (ztc[1:] - ztc[:-1])
    grad = jnp.where(ustar[None] > 0.0, grad, 0.0)
    grad_prev = jnp.concatenate([jnp.zeros_like(grad[:1]), grad[:-1]],
                                axis=0)
    hit = ((grad >= ustar[None]) & ((grad - grad_prev) != 0.0)
           & (ustar[None] > 0.0))

    bf = (grad - ustar[None]) / jnp.where((grad - grad_prev) != 0.0,
                                          grad - grad_prev, 1.0)
    zmid_dn = 0.5 * (ztc[1:] + ztc[:-1])          # -p5*(zgrid(k)+zgrid(k-1))
    zmid_up = jnp.concatenate(
        [jnp.broadcast_to(0.5 * zt[0], zmid_dn[:1].shape), zmid_dn[:-1]],
        axis=0)
    hcand = zmid_dn * (1.0 - bf) + zmid_up * bf

    # first hit wins (the reference resets USTAR to 0 after the first match)
    first_hit = hit & (jnp.cumsum(hit.astype(jnp.int32), axis=0) == 1)
    hmxl = jnp.where(jnp.any(first_hit, axis=0),
                     jnp.sum(jnp.where(first_hit, hcand, 0.0), axis=0),
                     hmxl)
    return hmxl


def blke(cfg: ModelConfig, grid: Grid, u, v, kbl):
    """Boundary-layer kinetic energy (erg/cm^2): 0.5 rho_sw (u^2+v^2) dz
    summed over k <= KBL (blke, source/vmix_kpp.F90:4072-4124)."""
    km = cfg.km
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    dz3 = jnp.reshape(grid.vgrid.dz, (km, 1, 1))
    ke = 0.5 * const.RHO_SW * (u ** 2 + v ** 2) * dz3
    return jnp.sum(jnp.where(kidx <= kbl[None], ke, 0.0), axis=0)


def niw_energy(cfg: ModelConfig, grid: Grid, st: KPPStatics, kbl,
               umix, vmix_, ucur=None, vcur=None):
    """NIW energy input En (compute_niw_energy_flux,
    source/vmix_kpp.F90:3888-4065): 'external' uses the prescribed flux;
    'blke' extracts 5% of the boundary-layer kinetic-energy change per
    step, zeroed within 5 degrees of the equator and cosine-tapered to 10
    degrees."""
    coef = (cfg.niw_local_mixing_fraction * cfg.niw_mixing_efficiency
            * cfg.niw_obs2model_ratio
            * (1.0 - cfg.niw_boundary_layer_absorption) / const.RHO_FW)
    if cfg.niw_energy_type == "blke" and ucur is not None:
        ke_mix = blke(cfg, grid, umix, vmix_, kbl)
        ke_cur = blke(cfg, grid, ucur, vcur, kbl)
        en = jnp.abs(0.05 * (ke_cur - ke_mix) / cfg.time.dtt)
        latd = grid.TLAT * const.RADIAN
        cosf = 0.5 * (jnp.cos(2.0 * jnp.pi * latd / 10.0) + 1.0)
        en = jnp.where(jnp.abs(latd) < 5.0, 0.0,
                       jnp.where(jnp.abs(latd) < 10.0, en * cosf, en))
        return coef * en * grid.RCALCT
    en_flux = (st.niw_energy if st.niw_energy is not None
               else jnp.asarray(cfg.niw_energy_const * 1000.0,
                                grid.TLAT.dtype))
    return coef * en_flux * grid.RCALCT


def niw_mix(cfg: ModelConfig, grid: Grid, st: KPPStatics, dbloc, hblt, kbl,
            visc, vdc_t, vdc_s, en=None):
    """Near-inertial-wave mixing (source/niw_mixing.F90 niw_mix :472-700):
    the NIW energy flux En deposits diffusivity kappa = En/N^2 below the
    boundary layer with an exponential decay away from its base, normalized
    over the column; within the boundary layer the kbl value applies, and
    the whole column is capped by it and by ``niw_mix_max``.

    The external-energy-flux option is supported (En from
    ``cfg.niw_energy_const`` W/m^2 or a file via KPPStatics.niw_energy);
    visc/vdc are (km+2, ...) interface arrays as in ri_iwmix.
    """
    km = cfg.km
    zw = grid.vgrid.zw[:, None, None]
    dzw = grid.vgrid.dzw[1:km + 1, None, None]
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1

    if en is None:
        en = niw_energy(cfg, grid, st, kbl, None, None)

    active = (kidx >= kbl[None]) & (kidx < grid.KMT[None])
    decay = jnp.exp(-(zw - hblt[None]) / cfg.niw_vert_decay_scale)
    norm = jnp.sum(jnp.where(active, decay * dzw, 0.0), axis=0)

    n2 = dbloc / dzw
    kap_n2 = jnp.where(n2 > 0.0, en[None] / jnp.where(n2 > 0.0, n2, 1.0),
                       0.0)
    kvniw = jnp.where((norm > 0.0)[None] & active,
                      kap_n2 * decay / jnp.where(norm > 0.0, norm, 1.0)
                      [None], 0.0)

    kvniw = jnp.where(active,
                      jnp.minimum(jnp.maximum(vdc_t[1:km + 1], kvniw),
                                  cfg.niw_mix_max), 0.0)
    # value at k == kbl fills the boundary layer and caps the column
    at_kbl = kidx == kbl[None]
    w4 = jnp.sum(jnp.where(at_kbl, kvniw, 0.0), axis=0)
    in_bl = kidx < kbl[None]

    def apply(vk):
        out = jnp.where(active, kvniw, vk[1:km + 1])
        out = jnp.where(in_bl, w4[None], out)
        out = jnp.minimum(out, w4[None])
        return vk.at[1:km + 1].set(out)

    vdc_t = apply(vdc_t)
    vdc_s = apply(vdc_s)
    visc_mid = jnp.where(active, cfg.prandtl * kvniw, visc[1:km + 1])
    visc_mid = jnp.where(in_bl, cfg.prandtl * w4[None], visc_mid)
    visc_mid = jnp.minimum(visc_mid, cfg.prandtl * w4[None])
    visc = visc.at[1:km + 1].set(visc_mid)
    return visc, vdc_t, vdc_s


def kpp_coeffs(cfg: ModelConfig, grid: Grid, bc: BC, st: KPPStatics,
               tmix, umix, vmix_, stf, shf_qsw, smft,
               convect_diff: float, convect_visc: float,
               ucur=None, vcur=None, chl=None, tidal_lnc=None,
               rhomix=None) -> KPPOut:
    """Full KPP pipeline (driver: source/vmix_kpp.F90:918-1422)."""
    km = cfg.km

    dbloc, dbsfc = buoydiff(cfg, grid, st, tmix)
    visc, vdc_s, kvmix, kvmix_m = ri_iwmix(cfg, grid, bc, st, dbloc, umix,
                                           vmix_, tidal_lnc=tidal_lnc,
                                           want_kvmix=True)
    vdc_t = vdc_s
    if cfg.kpp_ldbl_diff:
        vdc_t, vdc_s = ddmix(cfg, grid, tmix, vdc_t, vdc_s)
    hblt, ustar, bfsfc, stable, kbl = bldepth(
        cfg, grid, bc, st, dbloc, dbsfc, tmix, umix, vmix_, stf, shf_qsw,
        smft, chl=chl)
    if cfg.lniw_mixing:
        en = niw_energy(cfg, grid, st, kbl, umix, vmix_, ucur, vcur)
        visc, vdc_t, vdc_s = niw_mix(cfg, grid, st, dbloc, hblt, kbl,
                                     visc, vdc_t, vdc_s, en=en)
    visc, vdc_t, vdc_s, ghat = blmix(
        cfg, grid, st, visc, vdc_t, vdc_s, hblt, ustar, bfsfc, stable, kbl)

    # interior convection (step-function form, BVSQcon = 0;
    # source/vmix_kpp.F90:1218-1242)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    n2 = dbloc / jnp.reshape(grid.vgrid.dzw[1:km + 1], (km, 1, 1))
    fcon = (n2 <= 0.0).astype(n2.dtype)
    conv_on = (kidx >= kbl[None]) & (kidx <= km - 1)
    conv_vvc = jnp.where(conv_on, convect_visc * fcon, 0.0)
    conv_vdc = jnp.where(conv_on, convect_diff * fcon, 0.0)

    below = kidx >= grid.KMT[None]
    visc_k = jnp.where(below, 0.0, visc[1:km + 1] + conv_vvc)
    vdct_k = jnp.where(below, 0.0, vdc_t[1:km + 1] + conv_vdc)
    vdcs_k = jnp.where(below, 0.0, vdc_s[1:km + 1] + conv_vdc)
    visc_k = visc_k.at[-1].set(0.0)
    vdct_k = vdct_k.at[-1].set(0.0)
    vdcs_k = vdcs_k.at[-1].set(0.0)

    # viscosity to U grid (source/vmix_kpp.F90:1257-1263)
    vvc = tgrid_to_ugrid(visc_k, grid.AU0, grid.AUN, grid.AUE, grid.AUNE, bc)
    below_u = kidx >= grid.KMU[None]
    vvc = jnp.where(below_u, 0.0, vvc)

    # non-local source factor VDC*GHAT per class (:1293-1308)
    ghat_src = jnp.stack([vdct_k * ghat, vdcs_k * ghat])

    hmxl = hmxl_diag(cfg, grid, dbsfc)

    # TPOWER = KVMIX * RHO * DBLOC / dzw, energy used by vertical mixing
    # (:1947-1950); RHOMIX optional (the in-situ density at mix time)
    tpower = None
    if rhomix is not None:
        dzw_b = jnp.reshape(grid.vgrid.dzw[1:km + 1], (km, 1, 1))
        tpower = kvmix * rhomix * dbloc / dzw_b

    return KPPOut(vdc=jnp.stack([vdct_k, vdcs_k]), vvc=vvc,
                  ghat_src=ghat_src, hblt=hblt, kbl=kbl, hmxl=hmxl,
                  kvmix=kvmix, kvmix_m=kvmix_m, tpower=tpower,
                  hmxl_dr=hmxl_dr_diag(cfg, grid, tmix))


def kpp_sources(cfg: ModelConfig, grid: Grid, ghat_src, stf):
    """Non-local transport tracer source KPP_SRC (nt, km, ny, nx)
    (source/vmix_kpp.F90:1293-1308 + add_kpp_sources :3633)."""
    nt = stf.shape[0]
    km = cfg.km
    mt2 = jnp.minimum(jnp.arange(nt), 1)
    vg = ghat_src[mt2]                       # (nt, km, ny, nx)
    vg_up = jnp.concatenate([jnp.zeros_like(vg[:, :1]), vg[:, :-1]], axis=1)
    dzr = jnp.reshape(grid.vgrid.dzr, (1, km, 1, 1))
    return stf[:, None] * dzr * (vg_up - vg)
