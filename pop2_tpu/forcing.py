"""Surface forcing.

Reference: ``source/forcing.F90`` dispatch + per-field modules. Round 1
implements the standalone analytic options matching the reference's test
configuration (``input_templates/test_pop2_in``): analytic zonal wind stress
(source/forcing_ws.F90:266-292), zero heat/freshwater/interior restoring.
File-based and coupled forcing arrive with the gx-grid support.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from pop2_tpu import pytree

from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid


@pytree.dataclass
class Forcing:
    smf: jnp.ndarray       # (2, ny, nx) surface momentum flux at U points
    smft: jnp.ndarray      # (2, ny, nx) same at T points
    stf: jnp.ndarray       # (nt, ny, nx) surface tracer fluxes
    tfw: jnp.ndarray       # (nt, ny, nx) tracer content of freshwater flux
    shf_qsw: jnp.ndarray   # (ny, nx) penetrating shortwave
    fw: jnp.ndarray        # (ny, nx) freshwater flux (cm/s)
    atm_press: jnp.ndarray  # (ny, nx) atmospheric pressure
    # optional 3-D interior restoring targets (km, ny, nx)
    # (source/forcing_pt_interior.F90 / forcing_s_interior.F90)
    pt_interior_data: Optional[jnp.ndarray] = None
    s_interior_data: Optional[jnp.ndarray] = None
    # optional gas-exchange inputs (cfc_mod.F90 'model' formulation)
    u10_sqr: Optional[jnp.ndarray] = None   # (ny, nx) 10-m wind^2 (cm^2/s^2)
    ifrac: Optional[jnp.ndarray] = None     # (ny, nx) sea-ice fraction
    tracer_atm: Optional[jnp.ndarray] = None  # (n_gas, 2) (nh, sh) per gas
    chl: Optional[jnp.ndarray] = None  # (ny, nx) surface chlorophyll mg/m^3
    #                                    (sw_absorption 'chlorophyll'/'file')
    roff_f: Optional[jnp.ndarray] = None  # (ny, nx) river runoff kg/m^2/s
    #                                       (estuary EBM exchange)
    # optional per-component coupler fluxes, retained in SI units purely
    # for the tavg registry (PREC_F/EVAP_F/... tavg fields,
    # source/forcing_coupled.F90 accumulate_tavg_field calls)
    prec_f: Optional[jnp.ndarray] = None    # rain+snow, kg/m^2/s
    snow_f: Optional[jnp.ndarray] = None    # kg/m^2/s
    evap_f: Optional[jnp.ndarray] = None    # kg/m^2/s
    melt_f: Optional[jnp.ndarray] = None    # ice melt water, kg/m^2/s
    ioff_f: Optional[jnp.ndarray] = None    # ice runoff, kg/m^2/s
    salt_f: Optional[jnp.ndarray] = None    # salt flux, kg(salt)/m^2/s
    senh_f: Optional[jnp.ndarray] = None    # sensible heat, W/m^2
    lwup_f: Optional[jnp.ndarray] = None    # longwave up, W/m^2
    lwdn_f: Optional[jnp.ndarray] = None    # longwave down, W/m^2
    melth_f: Optional[jnp.ndarray] = None   # ice melt heat, W/m^2
    tidal_lnc: Optional[jnp.ndarray] = None  # () 18.6-yr lunar-nodal-cycle
    #                        energy modulation (tidal_mixing.py LNC factors)


def analytic_forcing(cfg: ModelConfig, grid: Grid) -> Forcing:
    """Constant-in-time analytic wind stress
    tau_x = -cos(3*lat) (source/forcing_ws.F90:275-277), everything else zero.
    """
    dt = cfg.jnp_dtype
    ny, nx, nt = cfg.ny, cfg.nx, cfg.nt
    z = jnp.zeros((ny, nx), dt)
    smf = jnp.stack([-jnp.cos(3.0 * grid.ULAT) * grid.RCALCU, z])
    smft = jnp.stack([-jnp.cos(3.0 * grid.TLAT) * grid.RCALCT, z])
    return Forcing(
        smf=smf.astype(dt), smft=smft.astype(dt),
        stf=jnp.zeros((nt, ny, nx), dt), tfw=jnp.zeros((nt, ny, nx), dt),
        shf_qsw=z, fw=z, atm_press=z)


def restoring_forcing(cfg: ModelConfig, grid: Grid, base: Forcing,
                      sst_data=None, sss_data=None,
                      state_sst=None, state_sss=None,
                      tau_days: float = 30.0) -> Forcing:
    """Surface restoring toward prescribed SST/SSS climatology
    (shf_formulation='restoring', source/forcing_shf.F90 and
    source/forcing_sfwf.F90): STF = dz1*(data - model)/tau."""
    dz1 = grid.vgrid.dz[0]
    tau = tau_days * 86400.0
    stf = base.stf
    if sst_data is not None and state_sst is not None:
        stf = stf.at[0].add(grid.RCALCT * dz1 * (sst_data - state_sst) / tau)
    if sss_data is not None and state_sss is not None:
        stf = stf.at[1].add(grid.RCALCT * dz1 * (sss_data - state_sss) / tau)
    return base.replace(stf=stf)


def read_ws_file(path: str, ny: int, nx: int, dtype=">f8"):
    """Read a POP-format binary wind-stress file: 12 monthly records of
    (TAUX, TAUY) pairs — 24 (ny, nx) records total
    (forcing_ws.F90 monthly read :222-260). Returns (taux, tauy), each
    (12, ny, nx), dyn/cm^2."""
    import numpy as np
    raw = np.fromfile(path, dtype=dtype)
    need = 24 * ny * nx
    if raw.size < need:
        raise ValueError(f"wind-stress file holds {raw.size} values, "
                         f"need {need}")
    rec = raw[:need].reshape(12, 2, ny, nx).astype(np.float64)
    return rec[:, 0], rec[:, 1]


def file_wind_stress(cfg: ModelConfig, grid: Grid, base: Forcing,
                     taux_monthly, tauy_monthly, thour,
                     data_type: str = "monthly-equal",
                     interp: str = "linear") -> Forcing:
    """Monthly-climatology wind stress interpolated to model time
    (forcing_ws.F90 'monthly' data type + forcing_tools interpolation).

    taux/tauy_monthly: (12, ny, nx) at U points (dyn/cm^2); ``thour`` the
    model hour (host scalar or traced). Returns the forcing with SMF/SMFT
    replaced."""
    from pop2_tpu.forcing_tools import MonthlyClimatology
    from pop2_tpu.stencil import ugrid_to_tgrid
    from pop2_tpu.grid import grid_bc
    cx = MonthlyClimatology.create(taux_monthly, interp, data_type)
    cy = MonthlyClimatology.create(tauy_monthly, interp, data_type)
    taux = cx.at(thour) * grid.RCALCU
    tauy = cy.at(thour) * grid.RCALCU
    bc = grid_bc(cfg)
    smft = jnp.stack([ugrid_to_tgrid(taux, bc) * grid.RCALCT,
                      ugrid_to_tgrid(tauy, bc) * grid.RCALCT])
    return base.replace(smf=jnp.stack([taux, tauy]).astype(base.smf.dtype),
                        smft=smft.astype(base.smf.dtype))
