"""One model timestep.

Reference: ``source/step_mod.F90:126-894`` and ``source/surface_hgt.F90:131``.
The whole step — dh/dt, baroclinic explicit update, barotropic implicit
solve, tracer corrector, time filtering — is a single pure function suitable
for ``jax.jit`` with the step-type flags (leapfrog / averaging) static. The
reference's three-time-level index rotation (:827-831) becomes functional
reassembly of the two-level state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from pop2_tpu import baroclinic, barotropic, eos
from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.forcing import Forcing
from pop2_tpu.grid import Grid
from pop2_tpu.state import State
from pop2_tpu.stencil import BC, tgrid_to_ugrid


class StepDiagnostics(NamedTuple):
    solver_iters: jnp.ndarray
    solver_rr: jnp.ndarray


def dhdt(cfg: ModelConfig, grid: Grid, bc: BC, state: State):
    """Change of surface height at T and U points
    (source/surface_hgt.F90:131-332)."""
    dtp = cfg.time.dtp
    if cfg.sfc_layer == "varthick":
        dh = ((state.psurf_cur - state.psurf_old) / (const.GRAV * dtp)
              - state.fw_old)
    elif cfg.sfc_layer == "rigid":
        dh = jnp.zeros_like(state.psurf_cur)
    else:  # oldfree
        dh = (state.psurf_cur - state.psurf_old) / (const.GRAV * dtp)
    dhu = tgrid_to_ugrid(dh, grid.AU0, grid.AUN, grid.AUE, grid.AUNE, bc)
    dhu = jnp.where(grid.kmask_u[0], dhu, 0.0)
    return dh, dhu


def _avg_filter(cfg: ModelConfig, grid: Grid, ts_range, state: State,
                new: State) -> State:
    """Time-averaging filter step (source/step_mod.F90:663-796):
    old' = (old+cur)/2, cur' = (cur+new)/2, with thickness-weighted clamped
    averaging of the surface tracer layer for the variable-thickness case.

    ``new`` here is the post-step state whose *_cur slots hold new-time
    values and *_old slots hold the (unrotated) current values.
    """
    varthick = cfg.sfc_layer == "varthick"
    dz1 = grid.vgrid.dz[0]

    def avg(a, b):
        return 0.5 * (a + b)

    t_old, t_cur, t_new = state.tracer_old, state.tracer_cur, new.tracer_cur
    p_old, p_cur, p_new = state.psurf_old, state.psurf_cur, new.psurf_cur

    tracer_old = avg(t_old, t_cur)
    tracer_cur = avg(t_cur, t_new)

    if varthick:
        p_f_old = avg(p_old, p_cur)
        p_f_cur = avg(p_cur, p_new)

        def surf_avg(ta, tb, pa, pb, pf):
            wmin = jnp.minimum(ta[:, 0], tb[:, 0])
            wmax = jnp.maximum(ta[:, 0], tb[:, 0])
            num = 0.5 * ((dz1 + pa / const.GRAV)[None] * ta[:, 0]
                         + (dz1 + pb / const.GRAV)[None] * tb[:, 0])
            t1 = num / (dz1 + pf / const.GRAV)[None]
            return jnp.clip(t1, wmin, wmax)

        tracer_old = tracer_old.at[:, 0].set(
            surf_avg(t_old, t_cur, p_old, p_cur, p_f_old))
        tracer_cur = tracer_cur.at[:, 0].set(
            surf_avg(t_cur, t_new, p_cur, p_new, p_f_cur))
        psurf_old, psurf_cur = p_f_old, p_f_cur
    else:
        psurf_old, psurf_cur = avg(p_old, p_cur), avg(p_cur, p_new)

    # recompute densities from averaged tracers (source/step_mod.F90:781-790)
    rho_old = jnp.where(grid.kmask_t, eos.state(
        cfg, grid.vgrid.pressz, tracer_old[0], tracer_old[1], ts_range), 0.0)
    rho_cur = jnp.where(grid.kmask_t, eos.state(
        cfg, grid.vgrid.pressz, tracer_cur[0], tracer_cur[1], ts_range), 0.0)

    return State(
        tracer_old=tracer_old, tracer_cur=tracer_cur,
        u_old=avg(state.u_old, state.u_cur),
        u_cur=avg(state.u_cur, new.u_cur),
        v_old=avg(state.v_old, state.v_cur),
        v_cur=avg(state.v_cur, new.v_cur),
        rho_old=rho_old, rho_cur=rho_cur,
        ubtrop_old=avg(state.ubtrop_old, state.ubtrop_cur),
        ubtrop_cur=avg(state.ubtrop_cur, new.ubtrop_cur),
        vbtrop_old=avg(state.vbtrop_old, state.vbtrop_cur),
        vbtrop_cur=avg(state.vbtrop_cur, new.vbtrop_cur),
        psurf_old=psurf_old, psurf_cur=psurf_cur,
        gradpx_old=avg(state.gradpx_old, state.gradpx_cur),
        gradpx_cur=avg(state.gradpx_cur, new.gradpx_cur),
        gradpy_old=avg(state.gradpy_old, state.gradpy_cur),
        gradpy_cur=avg(state.gradpy_cur, new.gradpy_cur),
        pguess=0.5 * (new.pguess + new.psurf_cur),
        fw_old=0.5 * (new.fw_old + state.fw_old),
        qice=new.qice, aqice=new.aqice,
        rf_s_prev=new.rf_s_prev, rf_s_prev_valid=new.rf_s_prev_valid)


def step(cfg: ModelConfig, grid: Grid, bc: BC, ts_range, state: State,
         forcing: Forcing, leapfrog: bool, avg_ts: bool,
         pcsi_eigs: Optional[Tuple[float, float]] = None,
         precond=None,
         kpp_statics=None, sw_profile=None, passive=None,
         ovf_statics=None, with_extras: bool = False):
    """Advance one timestep (leapfrog, Euler-forward for the first step,
    optional averaging filter). All flags are static for jit.

    ``with_extras=True`` additionally returns the step-internal fields the
    tavg registry accumulates from inside the reference's physics routines
    (HBLT/HMXL from vmix_kpp.F90, VDC/VVC from vertical_mix.F90) as a third
    tuple element."""
    # 1. surface height change (source/step_mod.F90:361)
    dh, dhu = dhdt(cfg, grid, bc, state)

    # overflow transports: evaluated once, shared by the tracer exchange and
    # the barotropic continuity injection (ovf_driver/ovf_transports,
    # source/overflows.F90:3477,3754)
    ovf_trans = ovf_q = ovf_sel = ovf_sets_tavg = None
    if cfg.overflows and ovf_statics is not None:
        from pop2_tpu import overflows as ovf_mod
        ovf_trans = ovf_mod.transports(cfg, grid, ovf_statics,
                                       state.tracer_cur)
        if ovf_statics.sets is not None:
            # neutral-buoyancy product-set selection (ovf_loc_prd,
            # source/overflows.F90:4313-4360)
            ovf_sel, ovf_sets_tavg = ovf_mod.product_set_selection(
                cfg, grid, ovf_statics, state.tracer_cur, ovf_trans)
        ovf_q = ovf_mod.qsurf(cfg, grid, ovf_statics, ovf_trans,
                              sel=ovf_sel)

    # 2. explicit baroclinic update (source/step_mod.F90:375)
    bout = baroclinic.driver(cfg, grid, bc, ts_range, state, forcing,
                             dh, dhu, leapfrog, kpp_statics=kpp_statics,
                             sw_profile=sw_profile, passive=passive,
                             ovf_statics=ovf_statics, ovf_trans=ovf_trans,
                             ovf_sel=ovf_sel, ovf_sets_tavg=ovf_sets_tavg)

    # 3. implicit barotropic solve (source/step_mod.F90:437); at overflow
    # sidewall columns the vertically-integrated forcing is renormalized
    # for the sub-topography sidewall depth (ovf_rhs_brtrpc_momentum,
    # source/overflows.F90:5068-5224)
    zx, zy = bout.zx, bout.zy
    if (cfg.overflows and ovf_statics is not None
            and ovf_statics.zren is not None):
        zx = zx * ovf_statics.zren
        zy = zy * ovf_statics.zren
    tout = barotropic.driver(cfg, grid, bc, state, forcing, zx,
                             zy, leapfrog, pcsi_eigs, precond,
                             ovf_qsurf=ovf_q)

    # 4. corrector/adjustment pass (source/step_mod.F90:457)
    tracer_new, rho_new, qice, aqice = baroclinic.correct_adjust(
        cfg, grid, bc, ts_range, state, bout, tout.psurf_new, bout.vdc,
        leapfrog, avg_ts, passive=passive)

    # 5. full velocity = baroclinic' + barotropic (source/step_mod.F90:572)
    u_new = jnp.where(grid.kmask_u, bout.u_new + tout.ubtrop_new[None], 0.0)
    v_new = jnp.where(grid.kmask_u, bout.v_new + tout.vbtrop_new[None], 0.0)
    if (cfg.overflows and ovf_statics is not None
            and ovf_statics.mom_u is not None):
        # sidewall momentum sources: overflow column renormalization
        # (ovf_UV + ovf_UV_solution, source/overflows.F90:4848,5884)
        from pop2_tpu import overflows as ovf_mod
        u_new, v_new = ovf_mod.momentum_adjust(
            cfg, grid, ovf_statics, ovf_trans, ovf_sel, u_new, v_new,
            tout.ubtrop_new, tout.vbtrop_new)
        u_new = jnp.where(grid.kmask_u, u_new, 0.0)
        v_new = jnp.where(grid.kmask_u, v_new, 0.0)
    if cfg.ldamp_uv:
        # optional velocity damping of the new time level
        # (damping.F90 damping_uv, called from step_mod.F90:600-602)
        spy = 365.0 * 86400.0 / cfg.time.dtt
        u_new = u_new * (1.0 - jnp.minimum(0.99, jnp.abs(u_new) / spy))
        v_new = v_new * (1.0 - jnp.minimum(0.99, jnp.abs(v_new) / spy))

    # 6. pressure guess extrapolation (source/step_mod.F90:634-640)
    pguess = (3.0 * (tout.psurf_new - state.psurf_cur) + state.psurf_old)

    ubtrop_new, vbtrop_new = tout.ubtrop_new, tout.vbtrop_new
    gradpx_new, gradpy_new = tout.gradpx_new, tout.gradpy_new
    if cfg.ns_boundary == "tripole":
        # the top U row lies on the fold and is degenerate: each point
        # coincides with its index-reversed partner; keep them consistent
        # after every update (mpi/POP_HaloMod.F90:1977-1986)
        from pop2_tpu.tripole import enforce_top_symmetry as ets
        u_new = ets(u_new)
        v_new = ets(v_new)
        ubtrop_new = ets(ubtrop_new)
        vbtrop_new = ets(vbtrop_new)
        gradpx_new = ets(gradpx_new)
        gradpy_new = ets(gradpy_new)

    new = State(
        tracer_old=state.tracer_cur, tracer_cur=tracer_new,
        u_old=state.u_cur, u_cur=u_new,
        v_old=state.v_cur, v_cur=v_new,
        rho_old=state.rho_cur, rho_cur=rho_new,
        ubtrop_old=state.ubtrop_cur, ubtrop_cur=ubtrop_new,
        vbtrop_old=state.vbtrop_cur, vbtrop_cur=vbtrop_new,
        psurf_old=state.psurf_cur, psurf_cur=tout.psurf_new,
        gradpx_old=state.gradpx_cur, gradpx_cur=gradpx_new,
        gradpy_old=state.gradpy_cur, gradpy_cur=gradpy_new,
        pguess=pguess, fw_old=forcing.fw, qice=qice, aqice=aqice,
        rf_s_prev=state.rf_s_prev,
        rf_s_prev_valid=state.rf_s_prev_valid)

    # 7. time filtering (source/step_mod.F90:663-832)
    rf_tend_tracer = None
    if cfg.time.time_mix_opt == "robert":
        prefilter = new.tracer_old
        new = _robert_filter(cfg, grid, bc, ts_range, state, new, forcing,
                             passive=passive)
        if with_extras:
            # Robert-filter tendency (RF_TEND_* tavg fields,
            # source/passive_tracers.F90:723-733): the filter increment
            # on the current time level per unit time
            rf_tend_tracer = (new.tracer_old - prefilter) / cfg.time.dtt
    elif avg_ts:
        new = _avg_filter(cfg, grid, ts_range, state, new)

    diags = StepDiagnostics(solver_iters=tout.solver_iters,
                            solver_rr=tout.solver_rr)
    if with_extras:
        kppo = bout.kpp
        extras = {
            "hblt": bout.kpp.hblt if bout.kpp is not None else None,
            "hmxl": bout.kpp.hmxl if bout.kpp is not None else None,
            "hmxl_dr": kppo.hmxl_dr if kppo is not None else None,
            "kvmix": kppo.kvmix if kppo is not None else None,
            "kvmix_m": kppo.kvmix_m if kppo is not None else None,
            "tpower": kppo.tpower if kppo is not None else None,
            "vdc": bout.vdc,
            "vvc": bout.vvc,
            "kappa_isop": (bout.gm.kappa_isop if bout.gm is not None
                           else None),
            "kappa_thic": (bout.gm.kappa_thic if bout.gm is not None
                           else None),
            "hor_diff": (bout.gm.hor_diff if bout.gm is not None
                         else None),
            # transition-layer geometry (DIA_DEPTH/TLT/INT_DEPTH,
            # source/hmix_gm.F90:2198-2209)
            "dia_depth": (bout.gm.dia_depth if bout.gm is not None
                          else None),
            "tlt_thick": (bout.gm.tlt_thick if bout.gm is not None
                          else None),
            "int_depth": (bout.gm.int_depth if bout.gm is not None
                          else None),
            # total tracer time tendency over this step, pre-filter
            # (TEND_TEMP/TEND_SALT, the reference's (TNEW-TOLD)/c2dt
            # accumulation in baroclinic.F90)
            "tend_tracer": ((tracer_new - state.tracer_cur
                             if not leapfrog else
                             tracer_new - state.tracer_old)
                            / jnp.reshape(
                                baroclinic._timestep_arrays(
                                    cfg, leapfrog)[0],
                                (1, cfg.km, 1, 1))),
            "rf_tend_tracer": rf_tend_tracer,
        }
        return new, diags, extras
    return new, diags


def _robert_filter(cfg: ModelConfig, grid: Grid, bc: BC, ts_range,
                   state: State, new: State, forcing: Forcing,
                   passive=None) -> State:
    """Robert-Asselin time filter (step_RF, source/step_mod.F90:919-1354).

    With the default robert_alpha = 1, robert_newtime = 0 and only the
    current time level is filtered:
      W = old + new - 2*cur;  cur += 0.5*nu*W
    Tracers are filtered thickness-weighted at the surface, PSURF and the
    tracers receive global conservation adjustments, and ice formation /
    passive resets / density recomputation happen on the filtered fields.

    ``new`` is the post-step rotated state (f_old = pre-step cur,
    f_cur = new-time values); ``state`` is the pre-step state.
    """
    rc = 0.5 * cfg.time.robert_nu * cfg.time.robert_alpha
    rn = 0.5 * cfg.time.robert_nu * (cfg.time.robert_alpha - 1.0)
    nonzero_new = cfg.time.robert_alpha != 1.0
    if cfg.sfc_layer != "varthick":
        raise NotImplementedError(
            "Robert filter requires the variable-thickness surface layer "
            "(source/step_mod.F90:1152)")

    def filt(o, c, n):
        w = o + n - 2.0 * c
        c2 = c + rc * w
        n2 = n + rn * w if nonzero_new else n
        return c2, n2

    ub_c, ub_n = filt(state.ubtrop_old, state.ubtrop_cur, new.ubtrop_cur)
    vb_c, vb_n = filt(state.vbtrop_old, state.vbtrop_cur, new.vbtrop_cur)
    gx_c, gx_n = filt(state.gradpx_old, state.gradpx_cur, new.gradpx_cur)
    gy_c, gy_n = filt(state.gradpy_old, state.gradpy_cur, new.gradpy_cur)
    u_c, u_n = filt(state.u_old, state.u_cur, new.u_cur)
    v_c, v_n = filt(state.v_old, state.v_cur, new.v_cur)

    t_old, t_cur, t_new = state.tracer_old, state.tracer_cur, new.tracer_cur
    p_old, p_cur, p_new = state.psurf_old, state.psurf_cur, new.psurf_cur
    dz1 = grid.vgrid.dz[0]

    # interior tracer filter (k >= 2); store S for conservation
    store_rf = t_old + t_new - 2.0 * t_cur
    t_cur_f = t_cur.at[:, 1:].add(rc * store_rf[:, 1:])
    t_new_f = t_new.at[:, 1:].add(rn * store_rf[:, 1:]) if nonzero_new \
        else t_new

    # surface: thickness-weighted filter (source/step_mod.F90:1071-1144)
    thick_o = dz1 + p_old / const.GRAV
    thick_c = dz1 + p_cur / const.GRAV
    thick_n = dz1 + p_new / const.GRAV
    s_sfc = (thick_o[None] * t_old[:, 0] + thick_n[None] * t_new[:, 0]
             - 2.0 * thick_c[None] * t_cur[:, 0])
    store_rf = store_rf.at[:, 0].set(s_sfc)

    # accumulate masked volume*S for conservation (:1051-1097)
    from pop2_tpu.reductions import global_sum
    mask3 = grid.kmask_t.astype(grid.TAREA.dtype)
    dzc = jnp.reshape(grid.vgrid.dz, (cfg.km, 1, 1))
    svol = global_sum(grid.TAREA[None, None] * mask3[None] * dzc[None]
                      * store_rf.at[:, 0].set(0.0), b4b=cfg.b4b,
                      axis=(1, 2, 3))
    svol = svol + global_sum(grid.TAREA[None] * mask3[0][None] * s_sfc,
                             b4b=cfg.b4b, axis=(1, 2))

    tth_c = thick_c[None] * t_cur[:, 0] + rc * s_sfc
    tth_n = (thick_n[None] * t_new[:, 0] + rn * s_sfc) if nonzero_new \
        else None

    # filter PSURF with its own conservation adjustment (:1099-1131)
    workb = p_old + p_new - 2.0 * p_cur
    p_cur_f = p_cur + rc * workb
    p_new_f = p_new + rn * workb if nonzero_new else p_new
    area = global_sum(grid.TAREA * grid.RCALCT, b4b=cfg.b4b)
    rf_sump = global_sum(workb * grid.TAREA * grid.RCALCT,
                         b4b=cfg.b4b) / area
    p_cur_f = p_cur_f - rc * rf_sump * grid.RCALCT
    if nonzero_new:
        p_new_f = p_new_f - rn * rf_sump * grid.RCALCT

    # recover surface tracers from thickness-weighted values (:1132-1142)
    thick_c_f = dz1 + p_cur_f / const.GRAV
    t_cur_f = t_cur_f.at[:, 0].set(tth_c / thick_c_f[None])
    if nonzero_new:
        thick_n_f = dz1 + p_new_f / const.GRAV
        t_new_f = t_new_f.at[:, 0].set(tth_n / thick_n_f[None])

    # global tracer conservation adjustment (:1160-1209)
    vol = (global_sum(mask3[1:] * dzc[1:] * grid.TAREA[None], b4b=cfg.b4b)
           + global_sum(mask3[0] * thick_c_f * grid.TAREA, b4b=cfg.b4b))
    rf_s = svol / vol
    # stabilized factor: average with the previous step's value once valid
    # (:1178-1184)
    factor = jnp.where(state.rf_s_prev_valid > 0.5,
                       0.5 * (rf_s + state.rf_s_prev), rf_s)
    t_cur_f = t_cur_f - (rc * factor)[:, None, None, None] * mask3[None]
    if nonzero_new:
        t_new_f = t_new_f - (rn * rf_s)[:, None, None, None] * mask3[None]

    # ice formation on both filtered levels + passive resets (:1239-1279)
    qice, aqice = new.qice, new.aqice
    if cfg.liceform:
        from pop2_tpu import ice as ice_mod
        t_cur_f, qice, aqice = ice_mod.ice_formation(
            cfg, grid, t_cur_f, p_cur_f, qice, aqice, 1.0)
        t_new_f, qice, aqice = ice_mod.ice_formation(
            cfg, grid, t_new_f, p_new_f, qice, aqice, 1.0)
    if passive is not None and passive.packages:
        t_cur_f = passive.reset(cfg, grid, t_cur_f)
        if nonzero_new:
            t_new_f = passive.reset(cfg, grid, t_new_f)

    # recompute densities for both levels (:1281-1288)
    rho_c = jnp.where(grid.kmask_t, eos.state(
        cfg, grid.vgrid.pressz, t_cur_f[0], t_cur_f[1], ts_range), 0.0)
    rho_n = jnp.where(grid.kmask_t, eos.state(
        cfg, grid.vgrid.pressz, t_new_f[0], t_new_f[1], ts_range), 0.0)

    # pressure guess from filtered levels (:1310-1316)
    pguess = 3.0 * (p_new_f - p_cur_f) + state.psurf_old

    return State(
        tracer_old=t_cur_f, tracer_cur=t_new_f,
        u_old=u_c, u_cur=u_n, v_old=v_c, v_cur=v_n,
        rho_old=rho_c, rho_cur=rho_n,
        ubtrop_old=ub_c, ubtrop_cur=ub_n,
        vbtrop_old=vb_c, vbtrop_cur=vb_n,
        psurf_old=p_cur_f, psurf_cur=p_new_f,
        gradpx_old=gx_c, gradpx_cur=gx_n,
        gradpy_old=gy_c, gradpy_cur=gy_n,
        pguess=pguess, fw_old=forcing.fw, qice=qice, aqice=aqice,
        rf_s_prev=rf_s, rf_s_prev_valid=jnp.ones_like(
            state.rf_s_prev_valid))
