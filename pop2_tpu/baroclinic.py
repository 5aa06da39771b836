"""Baroclinic (3-D explicit) dynamics driver.

Reference: ``source/baroclinic.F90`` — ``baroclinic_driver`` (:578, tracer and
momentum block loops), ``clinic`` (:1635, Fx/Fy assembly), ``tracer_update``
(:1902), ``baroclinic_correct_adjust`` (:1217). The reference's
per-block, per-level OMP loops with carried vertical state collapse into
whole-field (nt, km, ny, nx) expressions; halo updates disappear into the
shift ops.

Time-mixing: leapfrog with Euler-forward first step and time-averaging
(Matsuno is deliberately not rebuilt; SURVEY.md §7.4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pop2_tpu import advect, eos, hmix, pgrad, tridiag, vmix
from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.forcing import Forcing
from pop2_tpu.grid import Grid, thickness_t, thickness_u
from pop2_tpu.state import State
from pop2_tpu.stencil import BC


class BaroclinicOut(NamedTuple):
    tracer_new: jnp.ndarray  # predictor tracers (T,S updated if press avg)
    u_new: jnp.ndarray       # normalized baroclinic velocity U'
    v_new: jnp.ndarray
    rho_new: jnp.ndarray     # density from predictor T,S (press avg only)
    zx: jnp.ndarray          # (ny, nx) vertically-averaged forcing
    zy: jnp.ndarray
    vdc: jnp.ndarray         # (2, km, ny, nx) diffusivity used, for corrector
    vvc: jnp.ndarray = None  # (km, ny, nx) viscosity used (tavg extras)
    kpp: object = None       # KPPOut when vmix == 'kpp' (hblt/hmxl extras)
    gm: object = None        # GMOut when hmix_tracer == 'gm' (kappa extras)


def _dzt_arg(cfg: ModelConfig, grid: Grid):
    """Thickness argument for the implicit tracer solve: the 1-D profile
    normally, the 3-D DZT under partial bottom cells."""
    return grid.DZT if grid.DZT is not None else grid.vgrid.dz


def _dzu_arg(cfg: ModelConfig, grid: Grid):
    return grid.DZU if grid.DZU is not None else grid.vgrid.dz


def _timestep_arrays(cfg: ModelConfig, leapfrog: bool):
    """c2dt factors (source/step_mod.F90:302-320). With depth acceleration
    (laccel), dt(k) = dtt*dttxcel(k) with no acceleration in the top layer
    (source/time_management.F90:975-1009)."""
    dtt, dtu, dtp = cfg.time.dtt, cfg.time.dtu, cfg.time.dtp
    fac = 2.0 if leapfrog else 1.0
    if cfg.time.laccel and cfg.time.dttxcel is not None:
        if len(cfg.time.dttxcel) != cfg.km:
            raise ValueError(
                f"dttxcel has {len(cfg.time.dttxcel)} levels, need {cfg.km}")
        xcel = jnp.asarray(cfg.time.dttxcel, cfg.jnp_dtype).at[0].set(1.0)
        c2dtt = fac * dtt * xcel
    else:
        c2dtt = jnp.full((cfg.km,), fac * dtt, cfg.jnp_dtype)
    return c2dtt, fac * dtu, fac * dtp


def driver(cfg: ModelConfig, grid: Grid, bc: BC, ts_range,
           state: State, forcing: Forcing, dh, dhu,
           leapfrog: bool, kpp_statics=None,
           sw_profile=None, passive=None,
           ovf_statics=None, ovf_trans=None, ovf_sel=None,
           ovf_sets_tavg=None) -> BaroclinicOut:
    c2dtt, c2dtu, c2dtp = _timestep_arrays(cfg, leapfrog)
    beta = cfg.time.alpha if leapfrog else cfg.time.theta
    gamma = cfg.time.gamma
    varthick = cfg.sfc_layer == "varthick"
    press_avg = cfg.lpressure_avg and leapfrog

    if leapfrog:
        tmix, umix, vmix_m, rhomix = (state.tracer_old, state.u_old,
                                      state.v_old, state.rho_old)
    else:
        tmix, umix, vmix_m, rhomix = (state.tracer_cur, state.u_cur,
                                      state.v_cur, state.rho_cur)

    # chlorophyll field for the Ohlmann transmission, shared between the
    # KPP radiative bldepth term and add_sw_absorb below
    chl = None
    if cfg.sw_absorption == "chlorophyll":
        if cfg.chl_option == "model" and passive is not None:
            chl = passive.model_chl(state.tracer_cur)
        if chl is None and cfg.chl_option == "file":
            chl = forcing.chl
        if chl is None:
            chl = jnp.full_like(forcing.shf_qsw, cfg.chl_const)

    # ---- vertical mixing coefficients (source/baroclinic.F90:714-734) -----
    coeffs = vmix.vmix_coeffs(cfg, grid, bc, tmix, umix, vmix_m, rhomix,
                              forcing=forcing, kpp_statics=kpp_statics,
                              ucur=state.u_cur, vcur=state.v_cur, chl=chl)

    # surface fluxes incl. passive-tracer gas exchange etc.
    # (set_sflux_passive_tracers, source/passive_tracers.F90:988)
    stf = forcing.stf
    if passive is not None and passive.packages:
        stf = stf.at[2:].add(passive.set_sflux(
            cfg, grid, state.tracer_old, state.tracer_cur, forcing))
    forcing = forcing.replace(stf=stf)

    # ---- tracer tendencies (tracer_update, source/baroclinic.F90:1902) ----
    gm_diag = None
    if cfg.hmix_tracer == "gm":
        # GM/Redi tendency + its |S|^2 vertical diffusivity folded into
        # the implicit solve (source/hmix_gm.F90:1741-1748)
        from pop2_tpu import gm as gm_mod
        hblt = coeffs.kpp.hblt if (cfg.vmix == "kpp"
                                   and coeffs.kpp is not None) else None
        gm_out = gm_mod.hdifft_gm(cfg, grid, bc, ts_range, tmix,
                                  hblt=hblt, umix=umix, vmix_m=vmix_m)
        ft = gm_out.gtk
        gm_diag = gm_out
        coeffs = coeffs._replace(vdc=coeffs.vdc + gm_out.vdc_gm[None])
    else:
        ft = hmix.hdifft(cfg, grid, bc, tmix)
    if cfg.lsubmeso:
        # submesoscale mixed-layer restratification (mix_submeso.F90,
        # called alongside hdifft in tracer_update)
        from pop2_tpu import submeso as submeso_mod
        hmxl = coeffs.kpp.hmxl if (cfg.vmix == "kpp"
                                   and coeffs.kpp is not None) else None
        gtk_sm, _ = submeso_mod.submeso_tendency(cfg, grid, bc, ts_range,
                                                 tmix, hmxl=hmxl)
        ft = ft + gtk_sm
    fv = advect.comp_flux_vel(cfg, grid, bc, state.u_cur, state.v_cur, dh)
    ft = ft - advect.advt(cfg, grid, bc, fv, state.tracer_cur,
                          tmix=tmix, c2dtt=c2dtt)
    ft = ft + vmix.vdifft(cfg, grid, coeffs.vdc, state.tracer_old,
                          forcing.stf)
    if varthick:
        # freshwater tracer flux into the surface layer
        # (source/baroclinic.F90:2128-2138)
        dzr1 = grid.vgrid.dzr[0]
        ft = ft.at[:, 0].add(dzr1 * forcing.tfw)
    # KPP non-local transport source (add_kpp_sources,
    # source/vmix_kpp.F90:3633-3692)
    if cfg.vmix == "kpp":
        from pop2_tpu import kpp as kpp_mod
        ft = ft + kpp_mod.kpp_sources(cfg, grid, coeffs.kpp.ghat_src,
                                      forcing.stf)
    # penetrative shortwave heating (add_sw_absorb,
    # source/sw_absorption.F90:818)
    if cfg.sw_absorption == "jerlov" and sw_profile is not None:
        from pop2_tpu import sw_absorption as sw_mod
        ft = sw_mod.add_sw_absorb(cfg, grid, ft, forcing.shf_qsw, sw_profile)
    elif cfg.sw_absorption == "chlorophyll":
        # Ohlmann (2003) chlorophyll-dependent transmission; chl computed
        # above (shared with the KPP radiative bldepth term)
        from pop2_tpu import sw_absorption as sw_mod
        trans = sw_mod.chl_transmission(cfg, grid, chl)
        ft = sw_mod.add_sw_absorb(cfg, grid, ft, forcing.shf_qsw, trans)
    # passive-tracer interior sources (set_interior_passive_tracers,
    # source/passive_tracers.F90:768)
    if passive is not None and passive.packages:
        ft = ft.at[2:].add(passive.set_interior(
            cfg, grid, state.tracer_old, state.tracer_cur,
            forcing=forcing))
    # T/S interior restoring (set_pt_interior, forcing_pt_interior.F90:569-
    # 668; set_s_interior, forcing_s_interior.F90): restore toward the 3-D
    # climatology down to restore_max_level, optionally excluding the
    # surface layer
    kidx = jnp.arange(cfg.km)[:, None, None]
    for n, data, tau_d, maxlev, sfc in (
            (0, forcing.pt_interior_data, cfg.pt_interior_restore_tau_days,
             cfg.pt_interior_restore_max_level,
             cfg.pt_interior_surface_restore),
            (1, forcing.s_interior_data, cfg.s_interior_restore_tau_days,
             cfg.s_interior_restore_max_level,
             cfg.s_interior_surface_restore)):
        if data is not None:
            rtau = 1.0 / (tau_d * 86400.0)
            mask = grid.kmask_t & (kidx < maxlev)
            if not sfc:
                mask = mask & (kidx > 0)
            ft = ft.at[n].add(jnp.where(
                mask, rtau * (data - state.tracer_cur[n]), 0.0))
    # estuary exchange circulation (set_estuary_exch_circ,
    # source/estuary_vsf_mod.F90:645-755): vertical redistribution by the
    # box-model exchange flow at river points
    if cfg.lestuary_exch and forcing.roff_f is not None:
        from pop2_tpu import estuary as est_mod
        w_up, w_lo = est_mod.exchange_layer_weights(
            cfg, grid, cfg.est_h_upper, cfg.est_h_lower)
        ft = ft + est_mod.exchange_circulation(
            cfg, grid, state.tracer_cur, forcing.roff_f, w_up, w_lo)
    # overflow parameterization (ovf_driver, source/overflows.F90:3477;
    # conservative regional exchange form, see overflows.py)
    if cfg.overflows and ovf_statics is not None:
        from pop2_tpu import overflows as ovf_mod
        ft = ft + ovf_mod.tendency(cfg, grid, ovf_statics,
                                   state.tracer_cur, trans=ovf_trans,
                                   sel=ovf_sel, sets_tavg=ovf_sets_tavg)
    # geothermal bottom heat flux (geoheatflux.F90:69-232 +
    # vertical_mix.F90:1428-1443: VTFB = -geoflux at k == KMT where
    # zw(k) >= geoheatflux_depth; enters the tendency as +geoflux*dzr)
    if cfg.geoheatflux_const != 0.0:
        bottom = ((kidx == grid.KMT[None] - 1)
                  & (grid.vgrid.zw[:, None, None] >= cfg.geoheatflux_depth))
        geo = cfg.geoheatflux_const * const.HFLUX_FACTOR
        ft = ft.at[0].add(jnp.where(
            bottom, geo * grid.vgrid.dzr[:, None, None], 0.0))

    # ---- build RHS / predictor update (source/baroclinic.F90:2212-2300) ---
    c2dtt_b = jnp.reshape(c2dtt, (1, cfg.km, 1, 1))
    rhs = jnp.where(grid.kmask_t[None], c2dtt_b * ft, 0.0)
    if cfg.implicit_vertical_mix:
        if varthick and press_avg:
            # surface RHS for T,S predictor includes the known part of the
            # surface-height change (source/baroclinic.F90:2217-2222)
            pterm = (2.0 * state.tracer_cur[:2, 0]
                     * (state.psurf_cur - state.psurf_old)[None]
                     / (const.GRAV * grid.vgrid.dz[0]))
            surf = jnp.where(grid.kmask_t[0][None],
                             c2dtt[0] * ft[:2, 0] - pterm, 0.0)
            rhs = rhs.at[:2, 0].set(surf)

        tracer_new = state.tracer_old + rhs  # placeholder; replaced below
        if varthick and press_avg:
            # predictor tridiagonal update of T,S only, with PSURF(cur) on
            # the LHS (source/baroclinic.F90:885-895)
            dts = []
            for n in range(2):
                dT = tridiag.impvmixt(
                    rhs[n], coeffs.vdc[min(n, 1)], state.psurf_cur,
                    grid.KMT, _dzt_arg(cfg, grid), grid.vgrid.dzwr, c2dtt,
                    cfg.aidif, varthick=True)
                dts.append(state.tracer_old[n] + dT)
            tracer_new = jnp.concatenate(
                [jnp.stack(dts), rhs[2:]], axis=0) if cfg.nt > 2 \
                else jnp.stack(dts)
        elif not varthick:
            # tracer 0 has its own diffusivity class; 1..nt share vdc[1]
            # and one factorization
            dT0 = tridiag.impvmixt(
                rhs[0], coeffs.vdc[0], state.psurf_cur, grid.KMT,
                _dzt_arg(cfg, grid), grid.vgrid.dzwr, c2dtt,
                cfg.aidif, varthick=False)
            dTs = tridiag.impvmixt_batch(
                rhs[1:], coeffs.vdc[1], state.psurf_cur, grid.KMT,
                _dzt_arg(cfg, grid), grid.vgrid.dzwr, c2dtt,
                cfg.aidif, varthick=False)
            tracer_new = state.tracer_old + jnp.concatenate(
                [dT0[None], dTs], axis=0)
        else:
            # varthick without pressure averaging (or Euler step): full
            # update happens after the barotropic solve; carry the RHS
            tracer_new = rhs
    else:
        raise NotImplementedError("explicit vertical mixing path")

    # ---- density at new time for pressure averaging -----------------------
    if press_avg:
        rho_new = eos.state(cfg, grid.vgrid.pressz, tracer_new[0],
                            tracer_new[1], ts_range)
        rho_new = jnp.where(grid.kmask_t, rho_new, 0.0)
    else:
        rho_new = state.rho_cur

    # ---- momentum (clinic, source/baroclinic.F90:1635-1895) ---------------
    dzc = thickness_u(cfg, grid)
    fx, fy = clinic_forcing_jnp(
        cfg, grid, bc, state.u_cur, state.v_cur, state.u_old,
        state.v_old, umix, vmix_m, state.rho_old, state.rho_cur,
        rho_new, coeffs.vvc, forcing.smf, dhu, leapfrog)

    # vertical average of forcing, thickness-weighted under partial
    # bottom cells (source/baroclinic.F90:1035-1057); fx/fy are
    # already zero below the bottom
    zx = grid.HUR * jnp.sum(fx * dzc, axis=0)
    zy = grid.HUR * jnp.sum(fy * dzc, axis=0)

    # implicit Coriolis 2x2 transform (source/baroclinic.F90:1013-1027)
    if cfg.time.impcor:
        w1 = c2dtu * beta * grid.FCOR
        w2 = c2dtu / (1.0 + w1 ** 2)
        rhs_u = (fx + w1 * fy) * w2
        rhs_v = (fy - w1 * fx) * w2
    else:
        rhs_u = c2dtu * fx
        rhs_v = c2dtu * fy

    # implicit vertical friction (source/baroclinic.F90:1066-1069)
    if cfg.implicit_vertical_mix:
        rhs_u, rhs_v = tridiag.impvmixu(
            rhs_u, rhs_v, coeffs.vvc, grid.KMU, _dzu_arg(cfg, grid),
            grid.vgrid.dzwr, c2dtu, cfg.aidif)

    # unnormalized baroclinic velocity (source/baroclinic.F90:1077-1080)
    upp = state.u_old + rhs_u
    vpp = state.v_old + rhs_v

    # subtract vertical mean (source/baroclinic.F90:1092-1140)
    ubar = grid.HUR * jnp.sum(upp * dzc, axis=0)
    vbar = grid.HUR * jnp.sum(vpp * dzc, axis=0)
    u_new = jnp.where(grid.kmask_u, upp - ubar[None], 0.0)
    v_new = jnp.where(grid.kmask_u, vpp - vbar[None], 0.0)

    return BaroclinicOut(tracer_new=tracer_new, u_new=u_new, v_new=v_new,
                         rho_new=rho_new, zx=zx, zy=zy, vdc=coeffs.vdc,
                         vvc=coeffs.vvc, kpp=coeffs.kpp, gm=gm_diag)


def clinic_forcing_jnp(cfg, grid, bc, ucur, vcur, uold, vold, umix,
                       vmix_m, rho_old, rho_cur, rho_new, vvc, smf, dhu,
                       leapfrog: bool):
    """The explicit momentum forcing Fx, Fy = -L(u) + coriolis - grad(p)
    + D_H + D_V (clinic, source/baroclinic.F90:1635-1895). Returns
    (fx, fy) masked to ocean."""
    gamma = cfg.time.gamma
    luk, lvk = advect.advu(cfg, grid, bc, ucur, vcur, dhu)
    fx = -luk
    fy = -lvk

    if cfg.time.impcor and leapfrog:
        fx = fx + grid.FCOR * (gamma * vcur + (1.0 - gamma) * vold)
        fy = fy - grid.FCOR * (gamma * ucur + (1.0 - gamma) * uold)
    elif not cfg.time.impcor and leapfrog:
        fx = fx + grid.FCOR * vcur
        fy = fy - grid.FCOR * ucur
    else:
        fx = fx + grid.FCOR * vold
        fy = fy - grid.FCOR * uold

    bouss = pgrad.bouss_factor(cfg, grid.vgrid.pressz)
    pkx, pky = pgrad.gradp(cfg, grid, bc, bouss, rho_old, rho_cur,
                           rho_new, leapfrog)
    fx = fx - pkx
    fy = fy - pky

    hduk, hdvk = hmix.hdiffu(cfg, grid, bc, umix, vmix_m)
    fx = fx + hduk
    fy = fy + hdvk

    du, dv = vmix.vdiffu(cfg, grid, vvc, uold, vold, smf)
    fx = fx + du
    fy = fy + dv

    zero3 = jnp.zeros_like(fx)
    return (jnp.where(grid.kmask_u, fx, zero3),
            jnp.where(grid.kmask_u, fy, zero3))


def correct_adjust(cfg: ModelConfig, grid: Grid, bc: BC, ts_range,
                   state: State, out: BaroclinicOut, psurf_new,
                   coeffs_vdc, leapfrog: bool, avg_ts: bool = False,
                   passive=None):
    """Corrector/adjustment pass (source/baroclinic.F90:1217-1497):
    finish the tracer update with the new surface pressure, apply convective
    adjustment and freezing reset, and recompute the new density.

    ``coeffs_vdc``: the same vertical diffusivity used by the predictor.
    Returns (tracer_new, rho_new).
    """
    c2dtt, _, _ = _timestep_arrays(cfg, leapfrog)
    varthick = cfg.sfc_layer == "varthick"
    press_avg = cfg.lpressure_avg and leapfrog
    tracer_new = out.tracer_new
    grav_dz1 = const.GRAV * grid.vgrid.dz[0]

    if varthick and cfg.implicit_vertical_mix:
        if press_avg:
            # corrector RHS for T,S at the surface
            # (source/baroclinic.F90:1283-1296)
            dts = []
            for n in range(2):
                rhs1 = jnp.where(
                    grid.kmask_t[0],
                    ((2.0 * state.tracer_cur[n, 0] - state.tracer_old[n, 0])
                     * (state.psurf_cur - state.psurf_old)
                     - tracer_new[n, 0] * (psurf_new - state.psurf_cur))
                    / grav_dz1, 0.0)
                dT = tridiag.impvmixt_correct(
                    rhs1, coeffs_vdc[min(n, 1)], psurf_new, grid.KMT,
                    grid.vgrid.dz, grid.vgrid.dzwr, c2dtt, cfg.aidif,
                    varthick=True)
                dts.append(tracer_new[n] + dT)
            upd = jnp.stack(dts)
            if cfg.nt > 2:
                # passive tracers: surface RHS adjustment + full solve
                # (source/baroclinic.F90:1303-1321)
                rhs_p = tracer_new[2:].at[:, 0].add(jnp.where(
                    grid.kmask_t[0][None],
                    -state.tracer_old[2:, 0]
                    * (psurf_new - state.psurf_old)[None] / grav_dz1, 0.0))
                dTs = tridiag.impvmixt_batch(
                    rhs_p, coeffs_vdc[1], psurf_new, grid.KMT,
                    grid.vgrid.dz, grid.vgrid.dzwr, c2dtt, cfg.aidif,
                    varthick=True)
                upd = jnp.concatenate(
                    [upd, state.tracer_old[2:] + dTs], axis=0)
            tracer_new = upd
        else:
            # no pressure averaging (or Euler step): tracer_new holds the
            # RHS; apply the surface-pressure term and solve all tracers
            # (source/baroclinic.F90:1326-1344); psurf at mixtime is
            # psurf_cur for the Euler/non-avg path
            psurf_mix = state.psurf_cur
            rhs_all = tracer_new.at[:, 0].add(jnp.where(
                grid.kmask_t[0][None],
                -state.tracer_old[:, 0] * (psurf_new - psurf_mix)[None]
                / grav_dz1, 0.0))
            dT0 = tridiag.impvmixt(
                rhs_all[0], coeffs_vdc[0], psurf_new, grid.KMT,
                grid.vgrid.dz, grid.vgrid.dzwr, c2dtt, cfg.aidif,
                varthick=True)
            dTs = tridiag.impvmixt_batch(
                rhs_all[1:], coeffs_vdc[1], psurf_new, grid.KMT,
                grid.vgrid.dz, grid.vgrid.dzwr, c2dtt, cfg.aidif,
                varthick=True)
            tracer_new = state.tracer_old + jnp.concatenate(
                [dT0[None], dTs], axis=0)

    # reset surface temperature to freezing floor
    # (source/baroclinic.F90:1418-1421)
    if cfg.reset_to_freezing and not cfg.liceform:
        tracer_new = tracer_new.at[0, 0].set(
            jnp.maximum(tracer_new[0, 0], -2.0))

    # convective adjustment (no-op for convection_type='diffusion')
    tracer_new = vmix.convad(cfg, grid, tracer_new, ts_range)

    # passive-tracer resets (reset_passive_tracers,
    # source/baroclinic.F90:1458-1460)
    if passive is not None and passive.packages:
        tracer_new = passive.reset(cfg, grid, tracer_new)

    # frazil ice formation (source/baroclinic.F90:1442-1450)
    qice, aqice = state.qice, state.aqice
    if cfg.liceform:
        from pop2_tpu import ice as ice_mod
        time_weight = 0.5 if avg_ts else 1.0
        tracer_new, qice, aqice = ice_mod.ice_formation(
            cfg, grid, tracer_new, psurf_new, qice, aqice, time_weight)

    # recompute density from final tracers (source/baroclinic.F90:1476-1482)
    rho_new = eos.state(cfg, grid.vgrid.pressz, tracer_new[0], tracer_new[1],
                        ts_range)
    rho_new = jnp.where(grid.kmask_t, rho_new, 0.0)
    return tracer_new, rho_new, qice, aqice
