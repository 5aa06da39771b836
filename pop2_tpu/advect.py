"""Advection of momentum and tracers.

Reference: ``source/advection.F90`` — flux velocities ``comp_flux_vel``
(:1970), centered tracer advection ``advt_centered`` (:2139), momentum
advection with metric terms ``advu`` (:1127). The reference's
k-sequential carry of the vertical velocity (WTK -> WTKB per level) becomes a
masked ``cumsum`` over the whole column, and all levels/tracers are computed
at once. Schemes: centered, upwind3 (QUICKEST); lw_lim later.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid, thickness_t, thickness_u
from pop2_tpu.stencil import BC


class FluxVel(NamedTuple):
    """Tracer flux velocities across T-cell faces and vertical velocity."""
    ute: jnp.ndarray   # (km, ny, nx) east-face volume flux velocity
    utw: jnp.ndarray
    vtn: jnp.ndarray   # north face
    vts: jnp.ndarray
    wtk: jnp.ndarray   # (km, ny, nx) vertical velocity at TOP of each T box
    wtkb: jnp.ndarray  # (km, ny, nx) vertical velocity at BOTTOM of T box


def comp_flux_vel(cfg: ModelConfig, grid: Grid, bc: BC, uvel, vvel,
                  dh) -> FluxVel:
    """Flux velocities across T-cell faces and w from continuity
    (source/advection.F90:2066-2127), all levels at once.

    The surface boundary condition is w = DH (d(eta)/dt - F_w) for the
    variable-thickness surface layer. For k < KMT,
    WTKB_k = DH + sum_{m<=k} dz_m * FC_m, which equals the reference's
    per-level recurrence because masking can only first apply at k = KMT.
    """
    km = uvel.shape[0]
    dzu = thickness_u(cfg, grid)
    a = uvel * grid.DYU * dzu
    b = vvel * grid.DXU * dzu
    ute = 0.5 * (a + bc.s(a))
    utw = bc.w(ute)
    vtn = 0.5 * (b + bc.w(b))
    vts = bc.s(vtn)

    # fluxes carry the layer thickness (volume fluxes, cm^3/s; the
    # reference's partial-bottom-cell form, advection.F90:2066-2127, which
    # reduces to dz(k) times the uniform-cell form)
    fc = (vtn - vts + ute - utw) * grid.TAREA_R
    wtkb = dh[None] + jnp.cumsum(fc, axis=0)
    below = jnp.concatenate(  # k < KMT
        [grid.kmask_t[1:], jnp.zeros_like(grid.kmask_t[:1])])
    wtkb = jnp.where(below, wtkb, 0.0)
    wtk = jnp.concatenate([jnp.broadcast_to(dh[None], wtkb[:1].shape),
                           wtkb[:-1]], axis=0)
    return FluxVel(ute=ute, utw=utw, vtn=vtn, vts=vts, wtk=wtk, wtkb=wtkb)


def advt_centered(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr):
    """Centered tracer advection L(T) (source/advection.F90:2139-2306) for
    all tracers and levels: flux-form horizontal + centered vertical.

    trcr: (nt, km, ny, nx) tracers at current time.
    Returns L(T), (nt, km, ny, nx) — the caller subtracts it from FT.
    """
    km = cfg.km
    dzt = thickness_t(cfg, grid)
    ute, vtn = fv.ute[None], fv.vtn[None]
    uts = fv.vts[None]
    utw = fv.utw[None]
    cc = vtn - uts + ute - utw
    ltk = 0.5 * (cc * trcr
                 + vtn * bc.n(trcr) - uts * bc.s(trcr)
                 + ute * bc.e(trcr) - utw * bc.w(trcr)) \
        * grid.TAREA_R / dzt[None]

    # vertical advection (source/advection.F90:2266-2301); for the
    # variable-thickness surface layer there is no advection through the
    # surface at k=1
    dz2r = 0.5 / dzt[None]
    t_km1 = jnp.concatenate([trcr[:, :1], trcr[:, :-1]], axis=1)
    t_kp1 = jnp.concatenate([trcr[:, 1:], trcr[:, -1:]], axis=1)
    top = fv.wtk[None] * (t_km1 + trcr)
    if cfg.sfc_layer != "varthick":
        top = top.at[:, 0].set(2.0 * fv.wtk[0][None] * trcr[:, 0])
    else:
        top = top.at[:, 0].set(0.0)
    bot = fv.wtkb[None] * (trcr + t_kp1)
    bot = bot.at[:, -1].set(0.0)
    ltk = ltk + dz2r * (top - bot)
    return ltk


def advu(cfg: ModelConfig, grid: Grid, bc: BC, uvel, vvel, dhu):
    """Momentum advection L(U), L(V) with metric terms
    (source/advection.F90:1127-1570), all levels at once.

    Returns (luk, lvk), each (km, ny, nx), masked to zero on land.
    """
    km = cfg.km
    dzu = thickness_u(cfg, grid)
    a = uvel * grid.DYU * dzu
    b = vvel * grid.DXU * dzu
    # 4-point averages of T-face fluxes onto U-cell faces, thickness-
    # weighted (the reference's partial-bottom-cell form,
    # source/advection.F90:1245-1339; reduces to dz(k)x the uniform form)
    uuw = (0.25 * (a + bc.w(a))
           + 0.125 * (bc.s(a) + bc.sw(a) + bc.n(a, "necorner", "vector")
                      + bc.nw(a, "necorner", "vector")))
    uue = bc.e(uuw)
    vus = (0.25 * (b + bc.s(b))
           + 0.125 * (bc.w(b) + bc.sw(b) + bc.e(b) + bc.se(b)))
    # vus folds as an E-face vector given the degenerate top-row
    # antisymmetry of b (enforced each step for tripole grids)
    vun = bc.n(vus, "eface", "vector")

    # vertical velocity at U-box bottoms by continuity, integrated from the
    # surface value DHU (source/advection.F90:1345-1357)
    fc = (vun - vus + uue - uuw) * grid.UAREA_R
    wukb = dhu[None] + jnp.cumsum(fc, axis=0)
    wuk = jnp.concatenate([jnp.broadcast_to(dhu[None], wukb[:1].shape),
                           wukb[:-1]], axis=0)

    cc = vun - vus + uue - uuw
    luk = 0.5 * (cc * uvel + vun * bc.n(uvel, "necorner", "vector")
                 - vus * bc.s(uvel)
                 + uue * bc.e(uvel) - uuw * bc.w(uvel)) \
        * grid.UAREA_R / dzu
    lvk = 0.5 * (cc * vvel + vun * bc.n(vvel, "necorner", "vector")
                 - vus * bc.s(vvel)
                 + uue * bc.e(vvel) - uuw * bc.w(vvel)) \
        * grid.UAREA_R / dzu

    # vertical advection through top/bottom of U box
    # (source/advection.F90:1439-1471)
    dzr = 1.0 / dzu
    dz2r = 0.5 / dzu
    u_km1 = jnp.concatenate([uvel[:1], uvel[:-1]], axis=0)
    v_km1 = jnp.concatenate([vvel[:1], vvel[:-1]], axis=0)
    u_kp1 = jnp.concatenate([uvel[1:], uvel[-1:]], axis=0)
    v_kp1 = jnp.concatenate([vvel[1:], vvel[-1:]], axis=0)

    top_u = dz2r * wuk * (u_km1 + uvel)
    top_v = dz2r * wuk * (v_km1 + vvel)
    top_u = top_u.at[0].set(dzr[0] * wuk[0] * uvel[0])
    top_v = top_v.at[0].set(dzr[0] * wuk[0] * vvel[0])
    bot_u = dz2r * wukb * (uvel + u_kp1)
    bot_v = dz2r * wukb * (vvel + v_kp1)
    bot_u = bot_u.at[-1].set(0.0)
    bot_v = bot_v.at[-1].set(0.0)
    luk = luk + top_u - bot_u
    lvk = lvk + top_v - bot_v

    # metric terms (source/advection.F90:1479-1491)
    luk = luk + uvel * vvel * grid.KYU - vvel ** 2 * grid.KXU
    lvk = lvk + uvel * vvel * grid.KXU - uvel ** 2 * grid.KYU

    zero = jnp.zeros_like(luk)
    return (jnp.where(grid.kmask_u, luk, zero),
            jnp.where(grid.kmask_u, lvk, zero))


# ---------------------------------------------------------------------------
# 3rd-order upwind (QUICKEST) tracer advection
# (source/advection.F90:2313-2677; coefficients :420-562)
# ---------------------------------------------------------------------------

def _upwind3_vert_coeffs(dz):
    """Vertical QUICKEST interpolation coefficients
    (source/advection.F90:448-486). Returns 6 arrays of shape (km,)."""
    km = dz.shape[0]
    dzc = jnp.concatenate([dz[:1], dz, dz[-1:]])  # dzc(0..km+1), 1-based fold
    d_k = dz
    d_kp1 = jnp.concatenate([dz[1:], dz[-1:]])
    d_km1 = dzc[:km]          # dzc(k-1)
    d_kp2 = dzc[2:km + 2]     # dzc(k+2)

    talfzp = d_k * (2 * d_k + d_km1) / ((d_k + d_kp1)
                                        * (d_km1 + 2 * d_k + d_kp1))
    tbetzp = d_kp1 * (2 * d_k + d_km1) / ((d_k + d_kp1) * (d_k + d_km1))
    tgamzp = -(d_k * d_kp1) / ((d_k + d_km1) * (d_kp1 + d_km1 + 2 * d_k))
    tbetzp = tbetzp.at[0].add(tgamzp[0])
    tgamzp = tgamzp.at[0].set(0.0)
    talfzp = talfzp.at[km - 1].set(0.0)
    tbetzp = tbetzp.at[km - 1].set(0.0)
    tgamzp = tgamzp.at[km - 1].set(0.0)

    talfzm = d_k * (2 * d_kp1 + d_kp2) / ((d_k + d_kp1) * (d_kp1 + d_kp2))
    tbetzm = d_kp1 * (2 * d_kp1 + d_kp2) / ((d_k + d_kp1)
                                            * (d_k + d_kp2 + 2 * d_kp1))
    tdelzm = -(d_k * d_kp1) / ((d_kp1 + d_kp2) * (d_k + d_kp2 + 2 * d_kp1))
    talfzm = talfzm.at[km - 2].add(tdelzm[km - 2])
    tdelzm = tdelzm.at[km - 2].set(0.0)
    talfzm = talfzm.at[km - 1].set(0.0)
    tbetzm = tbetzm.at[km - 1].set(0.0)
    tdelzm = tdelzm.at[km - 1].set(0.0)
    return talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm


def _upwind3_horiz_coeffs(dc, dw, de, de2):
    """Face interpolation coefficients along one direction
    (source/advection.F90:510-551): dc/dw/de/de2 are the cell widths at
    (i), (i-1), (i+1), (i+2). Widths shifted in across closed boundaries are
    zero; clamp so land-row coefficients stay finite (they are masked out of
    the result anyway)."""
    tiny = 1.0e-20
    dc = jnp.maximum(dc, tiny)
    dw = jnp.maximum(dw, tiny)
    de = jnp.maximum(de, tiny)
    de2 = jnp.maximum(de2, tiny)
    alfp = dc * (2 * dc + dw) / ((dc + de) * (dw + 2 * dc + de))
    betp = de * (2 * dc + dw) / ((dc + dw) * (dc + de))
    gamp = -(dc * de) / ((dc + dw) * (dw + 2 * dc + de))
    alfm = dc * (2 * de + de2) / ((dc + de) * (de + de2))
    betm = de * (2 * de + de2) / ((dc + de) * (dc + 2 * de + de2))
    delm = -(dc * de) / ((de2 + de) * (dc + 2 * de + de2))
    return alfp, betp, gamp, alfm, betm, delm


def advt_upwind3(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr):
    """3rd-order upwind tracer advection L(T) for all tracers/levels
    (source/advection.F90:2313-2677). Land columns degrade the stencil to
    lower order by folding the missing-point weight into the remaining ones.
    """
    km = cfg.km
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1

    # -- horizontal: east-face upwind-interpolated tracer -------------------
    alfxp, betxp, gamxp, alfxm, betxm, delxm = _upwind3_horiz_coeffs(
        grid.DXT, bc.w(grid.DXT), bc.e(grid.DXT), bc.e(bc.e(grid.DXT)))
    alfyp, betyp, gamyp, alfym, betym, delym = _upwind3_horiz_coeffs(
        grid.DYT, bc.s(grid.DYT), bc.n(grid.DYT), bc.nn(grid.DYT))

    kmtee = bc.e(bc.e(grid.KMT.astype(jnp.int32)))
    kmtnn = bc.nn(grid.KMT.astype(jnp.int32))

    def faceval(X, c_pos, mask_up1, mask_dn1, mask_up2,
                alfp, betp, gamp, alfm, betm, delm, sh_p1, sh_m1, sh_p2):
        """Upwind-biased face value; X (nt,km,ny,nx), c_pos is the
        positive-flux condition at the face, masks gate stencil width."""
        ap = jnp.where(mask_up1, alfp, 0.0)
        work = jnp.where(mask_up1, betp, betp + alfp)
        bp = jnp.where(mask_dn1, work, work + gamp)
        gp = jnp.where(mask_dn1, gamp, 0.0)
        am = jnp.where(mask_up2, alfm, alfm + delm)
        dm = jnp.where(mask_up2, delm, 0.0)
        bm = betm
        plus = ap * sh_p1(X) + bp * X + gp * sh_m1(X)
        minus = am * sh_p1(X) + bm * X + dm * sh_p2(X)
        return jnp.where(c_pos, plus, minus)

    ce = (fv.ute * grid.TAREA_R)[None]
    cw = (-fv.utw * grid.TAREA_R)[None]
    cn = (fv.vtn * grid.TAREA_R)[None]
    cs = (-fv.vts * grid.TAREA_R)[None]

    mask_e = (kidx <= grid.KMTE[None])[None]
    mask_w = (kidx <= grid.KMTW[None])[None]
    mask_ee = (kidx <= kmtee[None])[None]
    tr_e = faceval(trcr, ce > 0, mask_e, mask_w, mask_ee,
                   alfxp, betxp, gamxp, alfxm, betxm, delxm,
                   bc.e, bc.w, lambda x: bc.e(bc.e(x)))
    mask_n = (kidx <= grid.KMTN[None])[None]
    mask_s = (kidx <= grid.KMTS[None])[None]
    mask_nn = (kidx <= kmtnn[None])[None]
    tr_n = faceval(trcr, cn > 0, mask_n, mask_s, mask_nn,
                   alfyp, betyp, gamyp, alfym, betym, delym,
                   bc.n, bc.s, bc.nn)

    dzt = thickness_t(cfg, grid)
    ltk = (ce * tr_e + cw * bc.w(tr_e)
           + cn * tr_n + cs * bc.s(tr_n)) / dzt[None]

    # -- vertical (source/advection.F90:2402-2476) --------------------------
    talfzp, tbetzp, tgamzp, talfzm, tbetzm, tdelzm = _upwind3_vert_coeffs(
        grid.vgrid.dz)

    def kcol(a):
        return jnp.reshape(a, (1, km, 1, 1))

    interior2 = (kidx < grid.KMT[None] - 1)[None]  # k < KMT-1
    azminus = jnp.where(interior2, kcol(talfzm), kcol(talfzm + tdelzm))
    dzminus = jnp.where(interior2, kcol(tdelzm), 0.0)

    t_kp1 = jnp.concatenate([trcr[:, 1:], trcr[:, -1:]], axis=1)
    t_km1 = jnp.concatenate([trcr[:, :1], trcr[:, :-1]], axis=1)
    t_kp2 = jnp.concatenate([trcr[:, 2:], trcr[:, -1:], trcr[:, -1:]],
                            axis=1)
    tplus = (kcol(talfzp) * t_kp1 + kcol(tbetzp) * trcr
             + kcol(tgamzp) * t_km1)
    tminus = azminus * t_kp1 + kcol(tbetzm) * trcr + dzminus * t_kp2
    wtkb = fv.wtkb[None]
    auxb = (wtkb - jnp.abs(wtkb)) * tplus + (wtkb + jnp.abs(wtkb)) * tminus
    auxb = auxb.at[:, -1].set(0.0)
    aux = jnp.concatenate([jnp.zeros_like(auxb[:, :1]), auxb[:, :-1]],
                          axis=1)

    dz2r = 0.5 / dzt[None]
    vert = dz2r * (aux - auxb)
    if cfg.sfc_layer != "varthick":
        vert = vert.at[:, 0].set(
            fv.wtk[0][None] * trcr[:, 0] / dzt[0]
            - 0.5 * auxb[:, 0] / dzt[0])
    return jnp.where(grid.kmask_t[None], ltk + vert, 0.0)


# ---------------------------------------------------------------------------
# 2nd-order forward-in-time advection with 1-D flux limiters (lw_lim)
# (source/advection.F90:2684-3331)
# ---------------------------------------------------------------------------

def _limit(dTR, dOther, LW, MU, base_plus, base_minus, upwind_pos):
    """One-dimensional Lax-Wendroff limiter (the psi_dTR pattern repeated
    throughout source/advection.F90:3100-3258): where dTR and the adjacent
    difference share a sign, blend toward the LW face value; otherwise fall
    back to pure upwind. ``upwind_pos`` selects the + (upstream-cell) form
    TRACER = base_plus + psi_dTR vs the - form TRACER = base_minus - psi_dTR.
    """
    both_pos = (dTR > 0.0) & (dOther > 0.0)
    both_neg = (dTR < 0.0) & (dOther < 0.0)
    psi = jnp.where(both_pos, jnp.minimum(LW * dTR, MU * dOther),
                    jnp.where(both_neg, jnp.maximum(LW * dTR, MU * dOther),
                              0.0))
    return jnp.where(upwind_pos, base_plus + psi, base_minus - psi)


def _lw_face_coeffs(vel_dt, d_c, d_dn):
    """LW_/MU_ face coefficients along one horizontal direction
    (source/advection.F90:2995-3065): ``vel_dt`` = dt * face velocity,
    ``d_c``/``d_dn`` the cell widths at (i) and (i+1). Returns (LW, MU)."""
    p5phr = 1.0 / (d_c + d_dn)
    LW = jnp.where(vel_dt > 0.0, (d_c - vel_dt) * p5phr,
                   jnp.where(vel_dt < 0.0, (d_dn + vel_dt) * p5phr,
                             d_c * p5phr))
    return LW


def _mu_coeffs(vel_dt, vel_dt_up, vel_dt_dn, d_c, d_dn, LW_up, LW_dn):
    """MU face coefficients (second factor of the limiter) along one
    direction. ``*_up``/``*_dn`` are the same quantities at the (i-1)/(i+1)
    faces (source/advection.F90:2986-3065)."""
    safe = jnp.where(vel_dt != 0.0, vel_dt, 1.0)
    mu_pos = jnp.where(vel_dt_up > 0.0, (d_c - vel_dt_up) / safe,
                       jnp.where(vel_dt_up < 0.0,
                                 -vel_dt_up / safe * LW_up, 0.0))
    mu_neg = jnp.where(vel_dt_dn < 0.0, -(d_dn + vel_dt_dn) / safe,
                       jnp.where(vel_dt_dn > 0.0,
                                 -vel_dt_dn / safe * LW_dn, 0.0))
    return jnp.where(vel_dt > 0.0, mu_pos,
                     jnp.where(vel_dt < 0.0, mu_neg, 0.0))


def advt_lw_lim(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, tmix,
                c2dtt):
    """Flux-limited Lax-Wendroff tracer advection L(T)
    (source/advection.F90:2684-3331), all tracers and levels at once.

    Unlike centered/upwind3, this scheme is forward-in-time: it advects the
    *mix-time* tracers ``tmix`` (advt dispatch, source/advection.F90:1698) and
    needs the advective timestep ``c2dtt`` (km,) for the limiter CFL factors.
    The reference's per-level AUX carry (top-face flux = previous level's
    bottom-face flux) becomes a shifted copy of the whole-column AUXB.

    The total tendency reduces to pure flux form:
      L(T) = (AUX - AUXB)/dz + CE*T_E + CW*T_E(w) + CN*T_N + CS*T_N(s),
    the advective-form intermediates only shape XSTAR, the provisional
    forward-updated tracer the limiters measure smoothness on.
    """
    km = cfg.km
    tiny = 1.0e-20
    dzt = jnp.broadcast_to(thickness_t(cfg, grid),
                           (km,) + grid.KMT.shape)
    adv_dt = jnp.reshape(c2dtt, (km, 1, 1))
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1  # 1-based

    # stencil weights (advt_lw_lim :2756-2775; the PBC form with TAREA_R/DZT
    # is uniformly correct for our volume fluxes, which carry dz)
    ce = fv.ute * grid.TAREA_R / dzt
    cw = -fv.utw * grid.TAREA_R / dzt
    cn = fv.vtn * grid.TAREA_R / dzt
    cs = -fv.vts * grid.TAREA_R / dzt

    # dt * face velocities (:2758-2768 PBC form: UTE/(HTE*min(DZT,DZT_e)))
    dzt_e = jnp.maximum(bc.e(dzt), tiny)
    dzt_n = jnp.maximum(bc.n(dzt), tiny)
    uvel_e_dt = adv_dt * fv.ute / (grid.HTE * jnp.minimum(dzt, dzt_e))
    vvel_n_dt = adv_dt * fv.vtn / (grid.HTN * jnp.minimum(dzt, dzt_n))

    # effective top-face velocity: no advection through the surface of a
    # variable-thickness surface layer (:2786-2790)
    wtk_eff = fv.wtk
    if cfg.sfc_layer == "varthick":
        wtk_eff = wtk_eff.at[0].set(0.0)
    wtkb = fv.wtkb
    wtkbp1 = jnp.concatenate([wtkb[1:], jnp.zeros_like(wtkb[:1])], axis=0)
    wtkb_safe = jnp.where(wtkb != 0.0, wtkb, 1.0)

    # -- vertical LW_z / MU_z (lw_lim :2919-2993, PBC form with edge clamp
    #    dz(km+1):=dz(km), reproducing p5_dz_ph_r(km)=0.5/dz(km) :604-605)
    dzt_kp1 = jnp.concatenate([dzt[1:], dzt[-1:]], axis=0)
    dzt_kp2 = jnp.concatenate([dzt[2:], dzt[-1:], dzt[-1:]], axis=0)
    dzt_km1 = jnp.concatenate([dzt[:1], dzt[:-1]], axis=0)
    down = wtkb > 0.0
    lw_z = jnp.where(down,
                     (dzt_kp1 - adv_dt * wtkb) / (dzt + dzt_kp1),
                     (dzt + adv_dt * wtkb) / (dzt + dzt_kp1))
    mu_z_pos = jnp.where(
        wtkbp1 > 0.0, (dzt_kp1 / adv_dt - wtkbp1) / wtkb_safe,
        jnp.where(wtkbp1 < 0.0,
                  -wtkbp1 / wtkb_safe * (dzt_kp1 + adv_dt * wtkbp1)
                  / (dzt_kp1 + dzt_kp2), 0.0))
    mu_z_neg = jnp.where(
        wtk_eff < 0.0, -(dzt / adv_dt + wtk_eff) / wtkb_safe,
        jnp.where(wtk_eff > 0.0,
                  -wtk_eff / wtkb_safe * (dzt - adv_dt * wtk_eff)
                  / (dzt_km1 + dzt), 0.0))
    mu_z = jnp.where(down, mu_z_pos, mu_z_neg)

    # -- vertical contribution (:3100-3160) ---------------------------------
    X = tmix
    x_kp1 = jnp.concatenate([X[:, 1:], X[:, -1:]], axis=1)
    x_kp2 = jnp.concatenate([X[:, 2:], X[:, -1:], X[:, -1:]], axis=1)
    x_km1 = jnp.concatenate([X[:, :1], X[:, :-1]], axis=1)

    valid_kp1 = ((kidx + 1) <= grid.KMT[None])[None]
    valid_kp2 = ((kidx + 2) <= grid.KMT[None])[None]
    not_top = (kidx > 1)[None]

    dTR = x_kp1 - X
    dTRp1 = jnp.where(valid_kp2, x_kp2 - x_kp1, 0.0)
    dTRm1 = jnp.where(not_top, X - x_km1, 0.0)
    auxb_pos = _limit(dTR, dTRp1, lw_z[None], mu_z[None],
                      x_kp1, x_kp1, jnp.asarray(False)) * wtkb[None]
    auxb_neg = _limit(dTR, dTRm1, lw_z[None], mu_z[None],
                      X, X, jnp.asarray(True)) * wtkb[None]
    auxb = jnp.where(valid_kp1,
                     jnp.where(down[None], auxb_pos,
                               jnp.where((wtkb < 0.0)[None], auxb_neg, 0.0)),
                     0.0)
    aux_top = (wtk_eff[0] * X[:, 0])[:, None]
    aux = jnp.concatenate([aux_top, auxb[:, :-1]], axis=1)
    xout = (aux - auxb - (wtk_eff - wtkb)[None] * X) / dzt[None]
    xstar = X - adv_dt[None] * xout

    # -- grid-x contribution (:3162-3215) ------------------------------------
    u = uvel_e_dt
    u_w, u_e = bc.w(u), bc.e(u)
    dxt = grid.DXT
    dxt_w = jnp.maximum(bc.w(dxt), tiny)
    dxt_e = jnp.maximum(bc.e(dxt), tiny)
    dxt_ee = jnp.maximum(bc.e(bc.e(dxt)), tiny)
    lw_x = _lw_face_coeffs(u, dxt, dxt_e)
    lw_x_w = _lw_face_coeffs(u_w, dxt_w, dxt)
    lw_x_e = _lw_face_coeffs(u_e, dxt_e, dxt_ee)
    mu_x = _mu_coeffs(u, u_w, u_e, dxt, dxt_e, lw_x_w, lw_x_e)

    kmaske = jnp.where((kidx <= grid.KMT[None])
                       & (kidx <= grid.KMTE[None]), 1.0, 0.0)
    kme_w = bc.w(kmaske)
    kme_e = bc.e(kmaske)

    xs_e, xs_w = bc.e(xstar), bc.w(xstar)
    xs_ee = bc.e(xs_e)
    dTR = (xs_e - xstar) * kmaske[None]
    dTRm1 = (xstar - xs_w) * kme_w[None]
    dTRp1 = (xs_ee - xs_e) * kme_e[None]
    tr_e = jnp.where(
        (ce > 0.0)[None],
        _limit(dTR, dTRm1, lw_x[None], mu_x[None], xstar, xstar,
               jnp.asarray(True)),
        jnp.where((ce < 0.0)[None],
                  _limit(dTR, dTRp1, lw_x[None], mu_x[None], xs_e, xs_e,
                         jnp.asarray(False)),
                  xstar + lw_x[None] * dTR))
    work = ce[None] * tr_e + cw[None] * bc.w(tr_e) - (ce + cw)[None] * X
    xout = xout + work
    xstar = xstar - adv_dt[None] * work

    # -- grid-y contribution + divergence term (:3220-3286) ------------------
    v = vvel_n_dt
    v_s = bc.s(v)
    v_n = bc.n(v)
    dyt = grid.DYT
    dyt_s = jnp.maximum(bc.s(dyt), tiny)
    dyt_n = jnp.maximum(bc.n(dyt), tiny)
    dyt_nn = jnp.maximum(bc.nn(dyt), tiny)
    lw_y = _lw_face_coeffs(v, dyt, dyt_n)
    lw_y_s = _lw_face_coeffs(v_s, dyt_s, dyt)
    lw_y_n = _lw_face_coeffs(v_n, dyt_n, dyt_nn)
    mu_y = _mu_coeffs(v, v_s, v_n, dyt, dyt_n, lw_y_s, lw_y_n)

    kmaskn = jnp.where((kidx <= grid.KMT[None])
                       & (kidx <= grid.KMTN[None]), 1.0, 0.0)
    kmn_s = bc.s(kmaskn)
    kmn_n = bc.n(kmaskn)

    xs_n, xs_s = bc.n(xstar), bc.s(xstar)
    xs_nn = bc.n(xs_n)
    dTR = (xs_n - xstar) * kmaskn[None]
    dTRm1 = (xstar - xs_s) * kmn_s[None]
    dTRp1 = (xs_nn - xs_n) * kmn_n[None]
    tr_n = jnp.where(
        (cn > 0.0)[None],
        _limit(dTR, dTRm1, lw_y[None], mu_y[None], xstar, xstar,
               jnp.asarray(True)),
        jnp.where((cn < 0.0)[None],
                  _limit(dTR, dTRp1, lw_y[None], mu_y[None], xs_n, xs_n,
                         jnp.asarray(False)),
                  xstar + lw_y[None] * dTR))
    div = (wtk_eff - wtkb) / dzt + ce + cw + cn + cs
    xout = xout + (cn[None] * tr_n + cs[None] * bc.s(tr_n)
                   - (cn + cs - div)[None] * X)
    return jnp.where(grid.kmask_t[None], xout, 0.0)


def advt(cfg: ModelConfig, grid: Grid, bc: BC, fv: FluxVel, trcr,
         tmix=None, c2dtt=None):
    """Tracer-advection dispatch (source/advection.F90:1684-1729); the
    reference allows per-tracer schemes, here one scheme for all tracers.
    ``trcr`` is the current-time tracer field (centered/upwind3); lw_lim
    advects the mix-time field ``tmix`` with per-level timestep ``c2dtt``."""
    if cfg.tadvect == "centered":
        return advt_centered(cfg, grid, bc, fv, trcr)
    if cfg.tadvect == "upwind3":
        return advt_upwind3(cfg, grid, bc, fv, trcr)
    if cfg.tadvect == "lw_lim":
        if tmix is None or c2dtt is None:
            raise ValueError("lw_lim advection needs tmix and c2dtt")
        return advt_lw_lim(cfg, grid, bc, fv, tmix, c2dtt)
    raise NotImplementedError(f"tadvect {cfg.tadvect}")
