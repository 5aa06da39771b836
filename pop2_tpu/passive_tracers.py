"""Passive-tracer framework.

Reference: ``source/passive_tracers.F90`` (the uniform per-package API every
tracer module implements: init / interior source / surface flux / reset /
tavg, :207-1562) and ``source/iage_mod.F90`` (the simplest package and the
template for new ones). Tracers occupy slots 2.. (0-based) of the tracer
array, after TEMP and SALT.

A package is a small object with pure functions returning whole
(km, ny, nx) source fields; the framework stacks per-package contributions
into the (nt, km, ny, nx) tendency in one shot.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from pop2_tpu import constants as const
from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid

SECONDS_IN_YEAR = 365.0 * 86400.0


class TracerPackage:
    """Base class: the reference's per-module API
    (source/passive_tracers.F90:768-1306)."""

    #: tracer names provided by this package, in slot order
    names: Sequence[str] = ()

    def n_tracers(self) -> int:
        return len(self.names)

    def init_values(self, cfg: ModelConfig, grid: Grid) -> np.ndarray:
        """(n, km, ny, nx) initial fields."""
        n = self.n_tracers()
        return np.zeros((n, cfg.km, cfg.ny, cfg.nx))

    def set_interior(self, cfg: ModelConfig, grid: Grid, tracers_old,
                     tracers_cur, forcing=None):
        """(n, km, ny, nx) interior source terms (dT/dt units);
        ``forcing`` carries surface fields some packages need (e.g. the
        ecosystem's shortwave for light limitation)."""
        return jnp.zeros((self.n_tracers(), cfg.km, cfg.ny, cfg.nx),
                         cfg.jnp_dtype)

    def set_sflux(self, cfg: ModelConfig, grid: Grid, tracers_old,
                  tracers_cur, forcing=None):
        """(n, ny, nx) surface fluxes (STF units)."""
        return jnp.zeros((self.n_tracers(), cfg.ny, cfg.nx), cfg.jnp_dtype)

    def reset(self, cfg: ModelConfig, grid: Grid, tracer_block):
        """Post-update adjustment (e.g. surface reset); gets and returns the
        (n, km, ny, nx) block of this package's tracers at new time."""
        return tracer_block


class IdealAge(TracerPackage):
    """Ideal-age tracer: ages 1 yr/yr in the interior, reset to zero in the
    surface layer (source/iage_mod.F90:325-415)."""

    names = ("IAGE",)

    def set_interior(self, cfg, grid, tracers_old, tracers_cur,
                     forcing=None):
        src = grid.kmask_t.astype(cfg.jnp_dtype) / SECONDS_IN_YEAR
        return src[None]

    def reset(self, cfg, grid, tracer_block):
        return tracer_block.at[:, 0].set(0.0)


class IRF(TracerPackage):
    """Impulse-response-function tracer (source/IRF_mod.F90): a passive
    dye initialized as a unit impulse in a prescribed box, advected and
    mixed with no interior sources — the transport-matrix diagnostic. The
    reference reads impulse locations from a file; the default impulse
    fills the surface layer of the domain's central quarter."""

    names = ("IRF",)

    def __init__(self, box=None):
        #: (kmin, kmax, jmin, jmax, imin, imax), inclusive, 0-based
        self.box = box

    def init_values(self, cfg, grid):
        v = np.zeros((1, cfg.km, cfg.ny, cfg.nx))
        if self.box is None:
            b = (0, 0, cfg.ny // 4, 3 * cfg.ny // 4,
                 cfg.nx // 4, 3 * cfg.nx // 4)
        else:
            b = self.box
        v[0, b[0]:b[1] + 1, b[2]:b[3] + 1, b[4]:b[5] + 1] = 1.0
        return v * np.asarray(grid.kmask_t)[None]


def _make_cfc():
    from pop2_tpu.gas_tracers import GasTracers
    return GasTracers(("CFC11", "CFC12"))


def _make_sf6():
    from pop2_tpu.gas_tracers import GasTracers
    return GasTracers(("SF6",))


def _make_abio_dic():
    from pop2_tpu.abio_dic import AbioDIC
    return AbioDIC()


def _make_ecosys():
    from pop2_tpu.ecosys import Ecosystem
    return Ecosystem()


REGISTRY = {
    "iage": IdealAge,
    "cfc": _make_cfc,      # source/cfc_mod.F90
    "sf6": _make_sf6,      # source/sf6_mod.F90
    "irf": IRF,            # source/IRF_mod.F90
    "abio_dic": _make_abio_dic,  # source/abio_dic_dic14_mod.F90
    "ecosys": _make_ecosys,      # source/ecosys_driver.F90 (MARBL/BEC)
}


class PassiveTracers:
    """Stacked view over the active packages; slot 0 of the stacked source
    array corresponds to tracer index 2 of the model state."""

    def __init__(self, cfg: ModelConfig, packages):
        """packages: names from REGISTRY or TracerPackage instances."""
        self.packages: List[TracerPackage] = [
            p if isinstance(p, TracerPackage) else REGISTRY[p]()
            for p in packages]
        self.names: List[str] = []
        for p in self.packages:
            p.slot0 = 2 + len(self.names)  # this package's tracer offset
            self.names.extend(p.names)
        if 2 + len(self.names) != cfg.nt:
            raise ValueError(
                f"cfg.nt={cfg.nt} but packages provide {len(self.names)} "
                f"tracers (need nt = 2 + that)")

    def init_values(self, cfg, grid) -> np.ndarray:
        if not self.packages:
            return np.zeros((0, cfg.km, cfg.ny, cfg.nx))
        return np.concatenate(
            [p.init_values(cfg, grid) for p in self.packages], axis=0)

    def set_interior(self, cfg, grid, tracers_old, tracers_cur,
                     forcing=None):
        return jnp.concatenate(
            [p.set_interior(cfg, grid, tracers_old, tracers_cur,
                            forcing=forcing)
             for p in self.packages], axis=0)

    def set_sflux(self, cfg, grid, tracers_old, tracers_cur, forcing=None):
        return jnp.concatenate(
            [p.set_sflux(cfg, grid, tracers_old, tracers_cur, forcing)
             for p in self.packages], axis=0)

    def model_chl(self, tracer_cur):
        """Surface chlorophyll (mg/m^3) from the ecosystem package when
        active (the reference's 'model' chl_option resolves the
        model_chlorophyll named field, source/sw_absorption.F90:332-345);
        None otherwise."""
        from pop2_tpu.ecosys import Ecosystem, IDX
        for p in self.packages:
            if isinstance(p, Ecosystem):
                s0 = p.slot0
                return (tracer_cur[s0 + IDX["spChl"], 0]
                        + tracer_cur[s0 + IDX["diatChl"], 0]
                        + tracer_cur[s0 + IDX["diazChl"], 0])
        return None

    def reset(self, cfg, grid, tracer_new):
        """Apply per-package resets to the full (nt, ...) new-time array."""
        i = 2
        for p in self.packages:
            n = p.n_tracers()
            blk = p.reset(cfg, grid, tracer_new[i:i + n])
            tracer_new = tracer_new.at[i:i + n].set(blk)
            i += n
        return tracer_new
