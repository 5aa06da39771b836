"""Time-averaged history output (tavg).

Reference: ``source/tavg.F90`` (7985 lines) — a multi-stream registry of ~630
accumulated fields written at stream frequencies, with the accumulators
checkpointed so running means survive restarts (:1570, :2325). This module
rebuilds the core mechanism as pure functions:

  * a registry of pure field functions (cfg, grid, state, aux) -> (ny,nx) or
    (km,ny,nx) arrays (the reference's scattered ``accumulate_tavg_field``
    calls become one jitted accumulation pass over the requested fields),
  * per-field accumulation methods avg / min / max, matching the reference's
    ``tavg_method_avg|min|max`` (source/tavg.F90:353-360, e.g. XMXL is the
    max and TMXL the min of HMXL over the interval, source/vmix_kpp.F90
    define_tavg_field calls),
  * per-stream accumulators summed on device, normalized and written on host,
    with an in-scan accumulation path (Model.run_compiled) so output streams
    do not break the fused-scan executable,
  * NetCDF3-classic output via scipy (PIO/netCDF parity target), with
    coordinates zt/TLAT/TLONG like the reference's tavg files,
  * accumulator save/restore for exact-restart of running means.

``aux`` carries what the reference accumulates from inside the step: the
forcing fields and the vertical-mixing internals (HBLT/HMXL/VDC/VVC come out
of the step as extras, source/vmix_kpp.F90 accumulate_tavg_field calls).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid
from pop2_tpu.state import State


class TavgAux(NamedTuple):
    """Step-internal quantities available to tavg field functions (the
    reference accumulates these from inside the physics routines)."""
    forcing: object = None
    bc: object = None
    hblt: Optional[jnp.ndarray] = None   # (ny, nx) KPP boundary-layer depth
    hmxl: Optional[jnp.ndarray] = None   # (ny, nx) mixed-layer depth
    vdc: Optional[jnp.ndarray] = None    # (2, km, ny, nx) tracer diffusivity
    vvc: Optional[jnp.ndarray] = None    # (km, ny, nx) viscosity
    kappa_isop: Optional[jnp.ndarray] = None  # (km, ny, nx) Redi kappa
    kappa_thic: Optional[jnp.ndarray] = None  # (km, ny, nx) GM bolus kappa
    hor_diff: Optional[jnp.ndarray] = None    # (km, ny, nx) srf-bl horiz ah
    dia_depth: Optional[jnp.ndarray] = None   # (ny, nx) GM diabatic depth
    tlt_thick: Optional[jnp.ndarray] = None   # (ny, nx) transition thickness
    int_depth: Optional[jnp.ndarray] = None   # (ny, nx) interior start depth
    tend_tracer: Optional[jnp.ndarray] = None  # (nt, km, ny, nx) dT/dt
    hmxl_dr: Optional[jnp.ndarray] = None     # (ny, nx) density-crit MLD
    kvmix: Optional[jnp.ndarray] = None       # (km, ny, nx) interior vdc
    kvmix_m: Optional[jnp.ndarray] = None     # (km, ny, nx) interior vvc
    tpower: Optional[jnp.ndarray] = None      # (km, ny, nx) mixing energy
    rf_tend_tracer: Optional[jnp.ndarray] = None  # (nt, km, ny, nx)


@dataclasses.dataclass(frozen=True)
class FieldDef:
    name: str
    long_name: str
    units: str
    ndims: int                     # 2 or 3
    fn: Callable                   # (cfg, grid, state, aux) -> array
    method: str = "avg"            # avg | min | max (tavg.F90:353-360)


FIELDS: Dict[str, FieldDef] = {}


def _register(name, long_name, units, ndims, fn, method="avg"):
    FIELDS[name] = FieldDef(name, long_name, units, ndims, fn, method)


# ---------------------------------------------------------------------------
# helpers shared by several field functions
# ---------------------------------------------------------------------------

def _flux_vel(cfg, grid, aux, state):
    """Recompute the tracer flux velocities from the state (the same
    comp_flux_vel the step ran, source/advection.F90:1970); dh/dt is a pure
    function of the state (surface_hgt.F90:131)."""
    from pop2_tpu import advect, step as step_mod
    dh, _ = step_mod.dhdt(cfg, grid, aux.bc, state)
    return advect.comp_flux_vel(cfg, grid, aux.bc, state.u_cur, state.v_cur,
                                dh)


def _pd(cfg, grid, state):
    """Potential density: EOS of (T,S) at every level evaluated at the
    level-1 pressure (state(k,1,...), source/advection.F90:1845)."""
    from pop2_tpu import eos
    p1 = jnp.full_like(grid.vgrid.pressz, grid.vgrid.pressz[0])
    pd = eos.state(cfg, p1, state.tracer_cur[0], state.tracer_cur[1], None)
    return jnp.where(grid.kmask_t, pd, 0.0)


def _q(cfg, grid, state):
    """Vertical gradient of density d(rho)/dz at level centers
    (source/advection.F90:1876-1920): rho of the level-(k-1)/(k+1) water
    displaced to level k, averaged with the in-situ value."""
    from pop2_tpu import eos
    km = cfg.km
    T, S = state.tracer_cur[0], state.tracer_cur[1]
    pz = grid.vgrid.pressz
    r_k = state.rho_cur  # in-situ at own level
    # rho(T_{k-1}, S_{k-1}) at level-k pressure
    t_up = jnp.concatenate([T[:1], T[:-1]], axis=0)
    s_up = jnp.concatenate([S[:1], S[:-1]], axis=0)
    r_up = eos.state(cfg, pz, t_up, s_up, None)
    work3 = 0.5 * (r_up + r_k)
    work3 = work3.at[0].set(r_k[0])
    # rho(T_{k+1}, S_{k+1}) at level-k pressure; at the column bottom use r_k
    t_dn = jnp.concatenate([T[1:], T[-1:]], axis=0)
    s_dn = jnp.concatenate([S[1:], S[-1:]], axis=0)
    r_dn = eos.state(cfg, pz, t_dn, s_dn, None)
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    at_bot = kidx == grid.KMT[None]
    work4 = jnp.where(at_bot, r_k, 0.5 * (r_dn + r_k))
    dzr = jnp.reshape(1.0 / grid.vgrid.dz, (km, 1, 1))
    return jnp.where(grid.kmask_t, (work3 - work4) * dzr, 0.0)


def _pv(cfg, grid, state, aux):
    """Potential vorticity Q*(curl(u,v)/TAREA + f_T)
    (source/advection.F90:1923-1926)."""
    from pop2_tpu.stencil import zcurl
    q = _q(cfg, grid, state)
    crl = zcurl(state.u_cur, state.v_cur, grid.DXU, grid.DYU,
                grid.kmask_t, aux.bc)
    return q * (crl * grid.TAREA_R + grid.FCORT[None])


def _face_flux_e(cfg, grid, state, aux, n):
    """UET/UES: tracer flux across the east face, FUE*(T + T_east)
    (source/advection.F90:1743-1776; our flux velocities carry dz, so the
    partial-bottom-cell form with the 1/DZT factor is uniformly correct)."""
    fv = _flux_vel(cfg, grid, aux, state)
    dzr = jnp.reshape(1.0 / grid.vgrid.dz, (cfg.km, 1, 1))
    fue = 0.5 * fv.ute * grid.TAREA_R * dzr
    t = state.tracer_cur[n]
    return fue * (t + aux.bc.e(t))


def _face_flux_n(cfg, grid, state, aux, n):
    fv = _flux_vel(cfg, grid, aux, state)
    dzr = jnp.reshape(1.0 / grid.vgrid.dz, (cfg.km, 1, 1))
    fvn = 0.5 * fv.vtn * grid.TAREA_R * dzr
    t = state.tracer_cur[n]
    return fvn * (t + aux.bc.n(t))


def _face_flux_t(cfg, grid, state, aux, n):
    """WTT/WTS: tracer flux across the top face
    (source/advection.F90:1781-1790)."""
    fv = _flux_vel(cfg, grid, aux, state)
    t = state.tracer_cur[n]
    t_up = jnp.concatenate([t[:1], t[:-1]], axis=0)
    dz2r = jnp.reshape(0.5 / grid.vgrid.dz, (cfg.km, 1, 1))
    out = dz2r * fv.wtk * (t + t_up)
    if cfg.sfc_layer == "varthick":
        out = out.at[0].set(0.0)
    else:
        out = out.at[0].set(fv.wtk[0] * t[0] / grid.vgrid.dz[0])
    return out


def _need(aux, attr, name):
    v = getattr(aux, attr, None)
    if v is None:
        raise ValueError(
            f"tavg field {name} needs step-internal '{attr}' — run through "
            f"Model (which passes step extras) or provide aux.{attr}")
    return v


def _sfc(cfg, grid, state, aux):
    return state.psurf_cur / const.GRAV


# ---------------------------------------------------------------------------
# registry — names/units follow the reference registrations
# (gx1v7_tavg_contents; define_tavg_field calls cited per group)
# ---------------------------------------------------------------------------

# -- sea surface / barotropic (surface_hgt.F90:90, barotropic.F90:152) ------
_register("SSH", "Sea Surface Height", "centimeter", 2, _sfc)
_register("SSH2", "SSH**2", "cm^2", 2,
          lambda c, g, s, a: (s.psurf_cur / const.GRAV) ** 2)
_register("SST", "Sea Surface Temperature", "degC", 2,
          lambda c, g, s, a: s.tracer_cur[0, 0])
_register("SST2", "SST**2", "degC^2", 2,
          lambda c, g, s, a: s.tracer_cur[0, 0] ** 2)
_register("SSS", "Sea Surface Salinity", "psu", 2,
          lambda c, g, s, a: s.tracer_cur[1, 0] * const.SALT_TO_PPT)
_register("SSS2", "SSS**2", "psu^2", 2,
          lambda c, g, s, a: (s.tracer_cur[1, 0] * const.SALT_TO_PPT) ** 2)
_register("SU", "Vertically Integrated U", "cm^2/s", 2,
          lambda c, g, s, a: g.HU * s.ubtrop_cur)
_register("SV", "Vertically Integrated V", "cm^2/s", 2,
          lambda c, g, s, a: g.HU * s.vbtrop_cur)


def _bsf(cfg, grid, state, aux):
    from pop2_tpu.diagnostics import barotropic_streamfunction
    return barotropic_streamfunction(cfg, grid, state)


_register("BSF", "Diagnostic barotropic streamfunction", "Sv", 2, _bsf)

# -- prognostic 3-D fields (baroclinic.F90:2349, :772) -----------------------
_register("TEMP", "Potential Temperature", "degC", 3,
          lambda c, g, s, a: s.tracer_cur[0])
_register("SALT", "Salinity", "gram/gram", 3,
          lambda c, g, s, a: s.tracer_cur[1])
_register("TEMP2", "Temperature**2", "degC^2", 3,
          lambda c, g, s, a: s.tracer_cur[0] ** 2)
_register("SALT2", "Salinity**2", "(g/g)^2", 3,
          lambda c, g, s, a: s.tracer_cur[1] ** 2)
_register("UVEL", "Velocity in grid-x direction", "cm/s", 3,
          lambda c, g, s, a: s.u_cur)
_register("VVEL", "Velocity in grid-y direction", "cm/s", 3,
          lambda c, g, s, a: s.v_cur)
_register("UVEL2", "UVEL**2", "cm^2/s^2", 3,
          lambda c, g, s, a: s.u_cur ** 2)
_register("VVEL2", "VVEL**2", "cm^2/s^2", 3,
          lambda c, g, s, a: s.v_cur ** 2)
_register("KE", "Horizontal Kinetic Energy", "cm^2/s^2", 3,
          lambda c, g, s, a: 0.5 * (s.u_cur ** 2 + s.v_cur ** 2))
_register("UV", "UV velocity product", "cm^2/s^2", 3,
          lambda c, g, s, a: s.u_cur * s.v_cur)
_register("RHO", "In-situ density", "g/cm^3", 3,
          lambda c, g, s, a: s.rho_cur)
_register("PD", "Potential density ref to surface", "g/cm^3", 3,
          lambda c, g, s, a: _pd(c, g, s))
_register("RHO_VINT", "Vertical integral of in-situ density", "g/cm^2", 2,
          lambda c, g, s, a: jnp.sum(
              jnp.reshape(g.vgrid.dz, (-1, 1, 1)) * s.rho_cur, axis=0))
_register("Q", "z-derivative of potential density", "g/cm^4", 3,
          lambda c, g, s, a: _q(c, g, s))
_register("PV", "Potential vorticity", "1/s", 3, _pv)

# -- vertical velocity and advective fluxes (advection.F90:1750-1799) --------
_register("WVEL", "Vertical velocity at top of T box", "cm/s", 3,
          lambda c, g, s, a: _flux_vel(c, g, a, s).wtk)
_register("WVEL2", "WVEL**2", "cm^2/s^2", 3,
          lambda c, g, s, a: _flux_vel(c, g, a, s).wtk ** 2)
_register("UET", "East flux of heat", "degC/s", 3,
          lambda c, g, s, a: _face_flux_e(c, g, s, a, 0))
_register("UES", "East flux of salt", "g/g/s", 3,
          lambda c, g, s, a: _face_flux_e(c, g, s, a, 1))
_register("VNT", "North flux of heat", "degC/s", 3,
          lambda c, g, s, a: _face_flux_n(c, g, s, a, 0))
_register("VNS", "North flux of salt", "g/g/s", 3,
          lambda c, g, s, a: _face_flux_n(c, g, s, a, 1))
_register("WTT", "Top flux of heat", "degC/s", 3,
          lambda c, g, s, a: _face_flux_t(c, g, s, a, 0))
_register("WTS", "Top flux of salt", "g/g/s", 3,
          lambda c, g, s, a: _face_flux_t(c, g, s, a, 1))

# -- forcing fields (forcing_shf.F90, forcing_sfwf.F90, forcing_ws.F90) -----
_register("SHF", "Total surface heat flux incl. shortwave", "W/m^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "SHF").stf[0]
          / const.HFLUX_FACTOR)
_register("SHF_QSW", "Penetrating solar heat flux", "W/m^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "SHF_QSW").shf_qsw
          / const.HFLUX_FACTOR)
_register("SFWF", "Virtual salt/freshwater flux", "kg/m^2/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "SFWF").fw
          / const.FWFLUX_FACTOR)
_register("FW", "Freshwater flux", "cm/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "FW").fw)
_register("TFW_T", "Heat content of freshwater flux", "degC*cm/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "TFW_T").tfw[0])
_register("TFW_S", "Salt content of freshwater flux", "g/g*cm/s", 2,
          lambda c, g, s, a: _need(a, "forcing", "TFW_S").tfw[1])
_register("TAUX", "Windstress in grid-x direction",
          "dyn s/(cm g) momentum flux (stress/rho_sw)", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUX").smf[0])
_register("TAUY", "Windstress in grid-y direction",
          "dyn s/(cm g) momentum flux (stress/rho_sw)", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUY").smf[1])
_register("TAUX2", "Windstress**2 in grid-x direction", "(cm^2/s^2)^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUX2").smf[0] ** 2)
_register("TAUY2", "Windstress**2 in grid-y direction", "(cm^2/s^2)^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "TAUY2").smf[1] ** 2)
_register("ATM_PRESS", "Atmospheric pressure", "dyn/cm^2", 2,
          lambda c, g, s, a: _need(a, "forcing", "ATM_PRESS").atm_press)


def _roff(cfg, grid, state, aux):
    f = _need(aux, "forcing", "ROFF_F")
    if f.roff_f is None:
        return jnp.zeros((cfg.ny, cfg.nx), cfg.jnp_dtype)
    return f.roff_f


def _ifrac(cfg, grid, state, aux):
    f = _need(aux, "forcing", "IFRAC")
    if f.ifrac is None:
        return jnp.zeros((cfg.ny, cfg.nx), cfg.jnp_dtype)
    return f.ifrac


_register("ROFF_F", "River runoff flux", "kg/m^2/s", 2, _roff)
_register("IFRAC", "Ice fraction from coupler", "fraction", 2, _ifrac)


def _fcomp(attr, name):
    """Per-component coupler flux retained on Forcing (SI units; the
    reference accumulates these in forcing_coupled.F90's tavg calls)."""
    def fn(cfg, grid, state, aux):
        f = _need(aux, "forcing", name)
        v = getattr(f, attr)
        if v is None:
            return jnp.zeros((cfg.ny, cfg.nx), cfg.jnp_dtype)
        return v
    return fn


_register("PREC_F", "Precipitation flux from coupler (rain+snow)",
          "kg/m^2/s", 2, _fcomp("prec_f", "PREC_F"))
_register("SNOW_F", "Snow flux from coupler", "kg/m^2/s", 2,
          _fcomp("snow_f", "SNOW_F"))
_register("EVAP_F", "Evaporation flux from coupler", "kg/m^2/s", 2,
          _fcomp("evap_f", "EVAP_F"))
_register("MELT_F", "Melt flux from coupler", "kg/m^2/s", 2,
          _fcomp("melt_f", "MELT_F"))
_register("IOFF_F", "Ice runoff flux due to coupler", "kg/m^2/s", 2,
          _fcomp("ioff_f", "IOFF_F"))
_register("SALT_F", "Salt flux from coupler", "kg(salt)/m^2/s", 2,
          _fcomp("salt_f", "SALT_F"))
_register("SENH_F", "Sensible heat flux from coupler", "W/m^2", 2,
          _fcomp("senh_f", "SENH_F"))
_register("LWUP_F", "Longwave up heat flux from coupler", "W/m^2", 2,
          _fcomp("lwup_f", "LWUP_F"))
_register("LWDN_F", "Longwave down heat flux from coupler", "W/m^2", 2,
          _fcomp("lwdn_f", "LWDN_F"))
_register("MELTH_F", "Ice melt heat flux from coupler", "W/m^2", 2,
          _fcomp("melth_f", "MELTH_F"))


# -- penetrating shortwave diagnostics (sw_absorption.F90:880-940) -----------
def _sw_trans_interfaces(cfg, grid):
    """Transmission at layer-top interfaces zw(0..km-1): 1 at the surface;
    Jerlov two-band decay below; top-layer absorption otherwise."""
    km = cfg.km
    if cfg.sw_absorption == "jerlov":
        from pop2_tpu import sw_absorption as sw_mod
        tops = jnp.concatenate([jnp.zeros((1,), cfg.jnp_dtype),
                                grid.vgrid.zw[:km - 1]])
        return sw_mod.sw_absorb_frac_jnp(tops, cfg.jerlov_water_type)
    trans = jnp.zeros((km,), cfg.jnp_dtype)
    return trans.at[0].set(1.0)


def _qsw_htp(cfg, grid, state, aux):
    f = _need(aux, "forcing", "QSW_HTP")
    trans = _sw_trans_interfaces(cfg, grid)
    below = trans[1] if cfg.km > 1 else 0.0
    return (f.shf_qsw * (trans[0] - below) / const.HFLUX_FACTOR
            * (grid.KMT > 0))


def _qsw_3d(cfg, grid, state, aux):
    f = _need(aux, "forcing", "QSW_3D")
    trans = _sw_trans_interfaces(cfg, grid)
    return jnp.where(grid.kmask_t,
                     f.shf_qsw[None] * trans[:, None, None]
                     / const.HFLUX_FACTOR, 0.0)


def _qsw_hbl(cfg, grid, state, aux):
    f = _need(aux, "forcing", "QSW_HBL")
    hblt = _need(aux, "hblt", "QSW_HBL")
    if cfg.sw_absorption == "jerlov":
        from pop2_tpu import sw_absorption as sw_mod
        absorb = sw_mod.sw_absorb_frac_jnp(hblt, cfg.jerlov_water_type)
        qsw = f.shf_qsw * (1.0 - absorb)
    else:
        qsw = f.shf_qsw
    return qsw / const.HFLUX_FACTOR * (grid.KMT > 0)


# -- tracer tendency components (baroclinic.F90 / advection.F90 /
#    horizontal_mix.F90 tavg accumulations). The advective and horizontal-
#    diffusive pieces are recomputed from the state exactly as the step
#    computed them (same functions); the total tendency and the implicit
#    vertical flux come from step extras / the step's diffusivity.
def _adv_3d(cfg, grid, state, aux, n):
    from pop2_tpu import advect, baroclinic
    fv = _flux_vel(cfg, grid, aux, state)
    c2dtt = baroclinic._timestep_arrays(cfg, True)[0]  # lw_lim needs it
    lt = advect.advt(cfg, grid, aux.bc, fv, state.tracer_cur,
                     tmix=state.tracer_old, c2dtt=c2dtt)
    return -lt[n]


def _vint(cfg, grid, f3):
    dzc = jnp.reshape(grid.vgrid.dz, (cfg.km, 1, 1))
    return jnp.sum(f3 * dzc, axis=0)


def _hdif_3d(cfg, grid, state, aux, n):
    from pop2_tpu import hmix
    if cfg.hmix_tracer == "gm":
        from pop2_tpu import gm as gm_mod
        out = gm_mod.hdifft_gm(cfg, grid, aux.bc, None, state.tracer_old,
                               hblt=aux.hblt, umix=state.u_old,
                               vmix_m=state.v_old)
        return out.gtk[n]
    return hmix.hdifft(cfg, grid, aux.bc, state.tracer_old)[n]


def _dia_impvf(cfg, grid, state, aux, n):
    """Diabatic implicit-vertical-diffusion flux across each level bottom
    face, VDC*(T_k - T_{k+1})/dzw of the updated tracers
    (source/vertical_mix.F90 tavg_DIA_IMPVF accumulation)."""
    vdc = _need(aux, "vdc", "DIA_IMPVF")[min(n, 1)]
    t = state.tracer_cur[n]
    t_kp1 = jnp.concatenate([t[1:], t[-1:]], axis=0)
    km = cfg.km
    dzwr = jnp.reshape(1.0 / grid.vgrid.dzw[1:km + 1], (km, 1, 1))
    kidx = jax.lax.broadcasted_iota(jnp.int32, (km, 1, 1), 0) + 1
    below = kidx < grid.KMT[None]
    return jnp.where(below, vdc * (t - t_kp1) * dzwr, 0.0)


_register("TEND_TEMP", "Tendency of Potential Temperature", "degC/s", 3,
          lambda c, g, s, a: _need(a, "tend_tracer", "TEND_TEMP")[0])
_register("TEND_SALT", "Tendency of Salinity", "(g/g)/s", 3,
          lambda c, g, s, a: _need(a, "tend_tracer", "TEND_SALT")[1])
_register("ADV_3D_TEMP", "T Advection Tendency", "degC/s", 3,
          lambda c, g, s, a: _adv_3d(c, g, s, a, 0))
_register("ADV_3D_SALT", "S Advection Tendency", "(g/g)/s", 3,
          lambda c, g, s, a: _adv_3d(c, g, s, a, 1))
_register("ADVT", "Vertically-Integrated T Advection Tendency",
          "degC cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _adv_3d(c, g, s, a, 0)))
_register("ADVS", "Vertically-Integrated S Advection Tendency",
          "(g/g) cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _adv_3d(c, g, s, a, 1)))
_register("HDIFT", "Vertically-Integrated T Horizontal Diffusion Tendency",
          "degC cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _hdif_3d(c, g, s, a, 0)))
_register("HDIFS", "Vertically-Integrated S Horizontal Diffusion Tendency",
          "(g/g) cm/s", 2,
          lambda c, g, s, a: _vint(c, g, _hdif_3d(c, g, s, a, 1)))
_register("DIA_IMPVF_TEMP", "T Diabatic Implicit Vertical Flux",
          "degC cm/s", 3, lambda c, g, s, a: _dia_impvf(c, g, s, a, 0))
_register("DIA_IMPVF_SALT", "S Diabatic Implicit Vertical Flux",
          "(g/g) cm/s", 3, lambda c, g, s, a: _dia_impvf(c, g, s, a, 1))


_register("QSW_HTP", "Solar short-wave heat flux in top layer", "W/m^2", 2,
          _qsw_htp)
_register("QSW_3D", "Solar short-wave heat flux at layer tops", "W/m^2", 3,
          _qsw_3d)
_register("QSW_HBL", "Solar short-wave heat flux in boundary layer",
          "W/m^2", 2, _qsw_hbl)

# -- ice formation (ice.F90 tavg_QICE) ---------------------------------------
_register("QICE", "Internal ocean heat used to form ice", "W/m^2", 2,
          lambda c, g, s, a: s.qice / const.HFLUX_FACTOR)
_register("AQICE", "Accumulated ice heat flux", "W/m^2", 2,
          lambda c, g, s, a: s.aqice / const.HFLUX_FACTOR)

# -- vertical-mixing internals (vmix_kpp.F90 bldepth/vmix_coeffs tavg) -------
_register("HBLT", "Boundary-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hblt", "HBLT"))
_register("XBLT", "Maximum Boundary-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hblt", "XBLT"), method="max")
_register("TBLT", "Minimum Boundary-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hblt", "TBLT"), method="min")
_register("HMXL", "Mixed-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "HMXL"))
_register("XMXL", "Maximum Mixed-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "XMXL"), method="max")
_register("TMXL", "Minimum Mixed-Layer Depth", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "TMXL"), method="min")
_register("VDC_T", "Vertical diffusivity, temperature class", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "vdc", "VDC_T")[0])
_register("VDC_S", "Vertical diffusivity, salinity class", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "vdc", "VDC_S")[1])
_register("VVC", "Vertical viscosity", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "vvc", "VVC"))


def _bck_vdc(cfg, grid):
    """Background internal-wave diffusivity field
    (vmix_kpp.F90:544-632 via kpp.background_vdc; covers both the atan
    profile and the lhoriz_varying latitude structure)."""
    from pop2_tpu import kpp as kpp_mod
    prof = jnp.asarray(kpp_mod.background_vdc(cfg, grid), cfg.jnp_dtype)
    return jnp.where(grid.kmask_t, jnp.broadcast_to(
        prof, (cfg.km, cfg.ny, cfg.nx)), 0.0)


_register("KAPPA_ISOP", "Isopycnal (Redi) diffusivity (cell avg of the "
          "tapered half-cell values)", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kappa_isop", "KAPPA_ISOP"))
_register("KAPPA_THIC", "Thickness (GM bolus) diffusivity (cell avg)",
          "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kappa_thic", "KAPPA_THIC"))
_register("HOR_DIFF", "Horizontal diffusivity in the surface diabatic "
          "layer (cell avg)", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "hor_diff", "HOR_DIFF"))
_register("DIA_DEPTH", "Depth of the Diabatic Region at the Surface",
          "centimeter", 2,
          lambda c, g, s, a: _need(a, "dia_depth", "DIA_DEPTH"))
_register("TLT", "Transition Layer Thickness", "centimeter", 2,
          lambda c, g, s, a: _need(a, "tlt_thick", "TLT"))
_register("INT_DEPTH", "Depth at which the Interior Region Starts",
          "centimeter", 2,
          lambda c, g, s, a: _need(a, "int_depth", "INT_DEPTH"))
_register("VDC_BCK", "Background vertical tracer diffusivity",
          "cm^2/s", 3, lambda c, g, s, a: _bck_vdc(c, g))
_register("VVC_BCK", "Background vertical viscosity", "cm^2/s", 3,
          lambda c, g, s, a: c.prandtl * _bck_vdc(c, g))
_register("KVMIX", "Vertical diabatic diffusivity due to Tidal Mixing + "
          "background", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kvmix", "KVMIX"))
_register("KVMIX_M", "Vertical viscosity due to Tidal Mixing + "
          "background", "cm^2/s", 3,
          lambda c, g, s, a: _need(a, "kvmix_m", "KVMIX_M"))
_register("TPOWER", "Energy Used by Vertical Mixing", "erg/s/cm^3", 3,
          lambda c, g, s, a: _need(a, "tpower", "TPOWER"))

# density-criterion mixed-layer depths (HMXL_DR, QL 150526,
# vmix_kpp.F90:1385-1417) + the stream-2 duplicate registrations of the
# mixed-layer fields (gx1v7_tavg_contents '2 HMXL_DR_2' etc.)
_register("HMXL_DR", "Mixed-Layer Depth (density)", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl_dr", "HMXL_DR"))
_register("HMXL_DR2", "Mixed-Layer Depth squared (density)",
          "centimeter^2", 2,
          lambda c, g, s, a: _need(a, "hmxl_dr", "HMXL_DR2") ** 2)
_register("XMXL_DR", "Maximum Mixed-Layer Depth (density)", "centimeter",
          2, lambda c, g, s, a: _need(a, "hmxl_dr", "XMXL_DR"),
          method="max")
_register("TMXL_DR", "Minimum Mixed-Layer Depth (density)", "centimeter",
          2, lambda c, g, s, a: _need(a, "hmxl_dr", "TMXL_DR"),
          method="min")
_register("HMXL_DR_2", "Mixed-Layer Depth (density, stream 2)",
          "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl_dr", "HMXL_DR_2"))
_register("HMXL_2", "Mixed-Layer Depth (stream 2)", "centimeter", 2,
          lambda c, g, s, a: _need(a, "hmxl", "HMXL_2"))
_register("XMXL_2", "Maximum Mixed-Layer Depth (stream 2)", "centimeter",
          2, lambda c, g, s, a: _need(a, "hmxl", "XMXL_2"), method="max")


def _qflux(c, g, s, a):
    """Internal ocean heat flux due to ice formation (W/m^2): the heat
    extracted by frazil formation this step, QICE/dt converted by the
    hflux factor (ice.F90 QFLUX; the reference holds QFLUX constant
    between ice timesteps — here the per-step equivalent)."""
    return jnp.where(g.kmask_t[0],
                     -s.qice / c.time.dtt / const.HFLUX_FACTOR, 0.0)


_register("QFLUX", "Internal Ocean Heat Flux Due to Ice Formation",
          "watt/m^2", 2, _qflux)


def _dtemp(c, g, s, a, sign):
    d = s.tracer_cur[0, 0] - s.tracer_old[0, 0]
    return (jnp.maximum(d, 0.0) if sign > 0 else jnp.minimum(d, 0.0))


_register("dTEMP_POS_2D", "max positive temperature timestep diff",
          "degC", 2, lambda c, g, s, a: _dtemp(c, g, s, a, +1))
_register("dTEMP_NEG_2D", "min negative temperature timestep diff",
          "degC", 2, lambda c, g, s, a: _dtemp(c, g, s, a, -1))


def _resid(c, g, s, a, n, factor):
    """Free-surface residual flux (RESID_T/RESID_S,
    source/baroclinic.F90:2416-2431): DH * tracer / conversion at the
    surface; identically zero under the variable-thickness surface layer
    (the reference only accumulates it for rigid/oldfree)."""
    if c.sfc_layer == "varthick":
        return jnp.zeros_like(s.psurf_cur)
    from pop2_tpu import step as step_mod
    dh, _ = step_mod.dhdt(c, g, a.bc, s)
    return jnp.where(g.kmask_t[0], dh * s.tracer_cur[n, 0] * factor, 0.0)


_register("RESID_T", "Free-Surface Residual Flux (T)", "watt/m^2", 2,
          lambda c, g, s, a: _resid(c, g, s, a, 0,
                                    1.0 / const.HFLUX_FACTOR))
_register("RESID_S", "Free-Surface Residual Flux (S)", "kg/m^2/s", 2,
          lambda c, g, s, a: _resid(c, g, s, a, 1,
                                    1.0 / const.SALINITY_FACTOR))

# weak-restoring virtual salt flux: nonzero only under the
# 'partially-coupled' sfwf formulation (source/forcing.F90:560-571
# sets WORK = c0 otherwise); the coupled path carries no weak restoring
_register("SFWF_WRST", "Virtual Salt Flux due to weak restoring",
          "kg/m^2/s", 2, lambda c, g, s, a: jnp.zeros_like(s.psurf_cur))

_register("RF_TEND_TEMP", "Robert Filter Tendency for TEMP", "degC/s", 3,
          lambda c, g, s, a: _need(a, "rf_tend_tracer", "RF_TEND_TEMP")[0])
_register("RF_TEND_SALT", "Robert Filter Tendency for SALT", "msu/s", 3,
          lambda c, g, s, a: _need(a, "rf_tend_tracer", "RF_TEND_SALT")[1])


def _estuary_exch_flux(c, g, s, a, n):
    """Vertical tracer flux across the EBM upper/lower layer interface
    (FLUX_EXCH_INTRF, source/estuary_vsf_mod.F90:727-751)."""
    if not c.lestuary_exch or a.forcing is None \
            or a.forcing.roff_f is None:
        return jnp.zeros_like(s.psurf_cur)
    from pop2_tpu import estuary as est_mod
    w_up, w_lo = est_mod.exchange_layer_weights(c, g, c.est_h_upper,
                                                c.est_h_lower)
    _, flux = est_mod.exchange_circulation(c, g, s.tracer_cur,
                                           a.forcing.roff_f, w_up, w_lo,
                                           want_flux=True)
    return flux[n]


_register("T_FLUX_EXCH_INTRF", "Vertical Temperature Flux Across "
          "Upper/Lower Layer Interface (From EBM)", "degC*cm/s", 2,
          lambda c, g, s, a: _estuary_exch_flux(c, g, s, a, 0))
_register("S_FLUX_EXCH_INTRF", "Vertical Salt Flux Across Upper/Lower "
          "Layer Interface (From EBM)", "msu*cm/s", 2,
          lambda c, g, s, a: _estuary_exch_flux(c, g, s, a, 1))


def _roff_vsf(c, g, s, a):
    """Surface virtual salt flux from river runoff (S_FLUX_ROFF_VSF_SRF,
    source/estuary_vsf_mod.F90:416-424)."""
    if not c.lestuary_exch or a.forcing is None \
            or a.forcing.roff_f is None:
        return jnp.zeros_like(s.psurf_cur)
    from pop2_tpu import estuary as est_mod
    return est_mod.river_vsf(c, g, a.forcing.roff_f, s.tracer_cur[1, 0])


_register("S_FLUX_ROFF_VSF_SRF", "Surface Salt Virtual Salt Flux "
          "Associated with Rivers (From VSF)", "msu*cm/s", 2, _roff_vsf)


def write_fields_netcdf(cfg, grid, fname: str, contents, arrays,
                        step_number: int = 0) -> str:
    """Shared stream writer with z_t/TLAT/TLONG coordinates (the
    reference's io_netcdf.F90/io_pio.F90 field-writing path). ``arrays``
    maps field name -> numpy array shaped per FIELDS[name].ndims.
    cfg.tavg_fmt_out selects NetCDF3-classic ('nc', scipy) or
    netCDF-4/HDF5 ('nc4', chunked + compressed, io/netcdf4.py)."""
    if getattr(cfg, "tavg_fmt_out", "nc") == "nc4":
        return _write_fields_nc4(cfg, grid, fname, contents, arrays,
                                 step_number)
    from scipy.io import netcdf_file
    with netcdf_file(fname, "w") as f:
        f.createDimension("time", 1)
        f.createDimension("z_t", cfg.km)
        f.createDimension("nlat", cfg.ny)
        f.createDimension("nlon", cfg.nx)

        zt = f.createVariable("z_t", "d", ("z_t",))
        zt[:] = np.asarray(grid.vgrid.zt)
        zt.units = b"centimeters"
        tlat = f.createVariable("TLAT", "d", ("nlat", "nlon"))
        tlat[:] = np.asarray(grid.TLAT) * const.RADIAN
        tlat.units = b"degrees_north"
        tlon = f.createVariable("TLONG", "d", ("nlat", "nlon"))
        tlon[:] = np.asarray(grid.TLON) * const.RADIAN
        tlon.units = b"degrees_east"
        tvar = f.createVariable("time", "d", ("time",))
        tvar[:] = [float(step_number)]
        tvar.units = b"steps"

        for n in contents:
            d = FIELDS[n]
            arr = np.asarray(arrays[n])
            dims = (("time", "z_t", "nlat", "nlon") if arr.ndim == 3
                    else ("time", "nlat", "nlon"))
            v = f.createVariable(n, "f", dims)
            v[:] = arr[None].astype(np.float32)
            v.units = d.units.encode()
            v.long_name = d.long_name.encode()
    return fname


def _write_fields_nc4(cfg, grid, fname, contents, arrays,
                      step_number: int = 0) -> str:
    """netCDF-4 flavor of write_fields_netcdf (io/netcdf4.py)."""
    from pop2_tpu.io.netcdf4 import write_netcdf4
    dims = {"time": 1, "z_t": cfg.km, "nlat": cfg.ny, "nlon": cfg.nx}
    variables = {
        "z_t": (("z_t",), np.asarray(grid.vgrid.zt),
                {"units": "centimeters"}),
        "time": (("time",), np.asarray([float(step_number)]),
                 {"units": "steps"}),
        "TLAT": (("nlat", "nlon"),
                 np.asarray(grid.TLAT) * const.RADIAN,
                 {"units": "degrees_north"}),
        "TLONG": (("nlat", "nlon"),
                  np.asarray(grid.TLON) * const.RADIAN,
                  {"units": "degrees_east"}),
    }
    for n in contents:
        d = FIELDS[n]
        arr = np.asarray(arrays[n])[None].astype(np.float32)
        vdims = (("time", "z_t", "nlat", "nlon") if arr.ndim == 4
                 else ("time", "nlat", "nlon"))
        variables[n] = (vdims, arr,
                        {"units": d.units, "long_name": d.long_name})
    return write_netcdf4(fname, dims, variables,
                         global_attrs={"title": "pop2_tpu tavg",
                                       "source": "pop2_tpu"})


class TavgStream:
    """One output stream: a set of fields accumulated every step and written
    every ``freq_steps`` steps (reference stream mechanism,
    source/tavg.F90:482-1568)."""

    def __init__(self, cfg: ModelConfig, grid: Grid, contents: List[str],
                 freq_steps: int, outfile_prefix: str = "tavg"):
        unknown = [n for n in contents if n not in FIELDS]
        if unknown:
            raise KeyError(f"unknown tavg fields: {unknown} "
                           f"(available: {sorted(FIELDS)})")
        self.cfg = cfg
        self.grid = grid
        self.contents = list(contents)
        self.freq_steps = freq_steps
        self.prefix = outfile_prefix
        self.nsamples = 0
        self.sums = self._zeros()

        defs = [FIELDS[n] for n in self.contents]

        def accum_tree(sums, state, aux):
            """Pure accumulation update — also used inside the run_compiled
            scan carry so output never breaks the fused executable."""
            out = {}
            for d in defs:
                val = d.fn(cfg, grid, state, aux)
                if d.method == "min":
                    out[d.name] = jnp.minimum(sums[d.name], val)
                elif d.method == "max":
                    out[d.name] = jnp.maximum(sums[d.name], val)
                else:
                    out[d.name] = sums[d.name] + val
            return out

        self.accum_tree = accum_tree
        self._accumulate = jax.jit(accum_tree)

    def _zeros(self):
        cfg = self.cfg
        z = {}
        big = jnp.asarray(jnp.finfo(cfg.jnp_dtype).max / 4, cfg.jnp_dtype)
        for n in self.contents:
            d = FIELDS[n]
            shape = ((cfg.km, cfg.ny, cfg.nx) if d.ndims == 3
                     else (cfg.ny, cfg.nx))
            if d.method == "min":
                z[n] = jnp.full(shape, big)
            elif d.method == "max":
                z[n] = jnp.full(shape, -big)
            else:
                z[n] = jnp.zeros(shape, cfg.jnp_dtype)
        return z

    def accumulate(self, state: State, aux: TavgAux = TavgAux()):
        self.sums = self._accumulate(self.sums, state, aux)
        self.nsamples += 1

    @property
    def ready(self) -> bool:
        return self.nsamples >= self.freq_steps

    def reset(self):
        self.sums = self._zeros()
        self.nsamples = 0

    def write(self, path: str, step_number: int = 0) -> str:
        """Write the normalized averages as NetCDF3 classic; returns path."""
        fname = f"{path}/{self.prefix}.{step_number:08d}.nc" \
            if not path.endswith(".nc") else path
        norm = 1.0 / max(self.nsamples, 1)
        arrays = {}
        for n in self.contents:
            a = np.asarray(self.sums[n])
            arrays[n] = a if FIELDS[n].method in ("min", "max") else a * norm
        write_fields_netcdf(self.cfg, self.grid, fname, self.contents,
                            arrays, step_number)
        return fname

    # -- accumulator checkpointing (read_tavg/write_tavg,
    #    source/tavg.F90:2325,1570) --
    def save_accumulators(self):
        return {"nsamples": self.nsamples,
                **{f"sum_{k}": np.asarray(v) for k, v in self.sums.items()}}

    def restore_accumulators(self, data):
        self.nsamples = int(data["nsamples"])
        self.sums = {k[4:]: jnp.asarray(v) for k, v in data.items()
                     if k.startswith("sum_")}
