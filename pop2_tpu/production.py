"""Production-configuration assembly.

``get_config('prod_full')`` carries the IO-free part of the reference's
gx1v7 default physics menu; this module attaches the pieces that come
from the reference's in-tree input files (``input_templates/``): the real
overflow geometry (Denmark Strait / Faroe Bank Channel / Ross Sea /
Weddell Sea with kmt pop-ups, region boxes, and sidewall orientations)
and the real 60-level vertical grid.

Reference: bld/namelist_files/namelist_defaults_pop.xml (defaults),
input_templates/gx1v7_overflow, input_templates/gx1v7_vert_grid.
"""

from __future__ import annotations

import os

from pop2_tpu.config import ModelConfig, SolverConfig, get_config

REF_TEMPLATES = "/root/reference/input_templates"


def get_production_config(name: str = "prod_full",
                          templates: str = REF_TEMPLATES,
                          **overrides) -> ModelConfig:
    """The flagship configuration with the reference's real auxiliary
    input data attached when available (falls back to the IO-free preset
    when the reference tree is absent)."""
    cfg = get_config(name)
    if os.path.isdir(templates):
        from pop2_tpu.io import input_templates as it
        vg = os.path.join(templates, "gx1v7_vert_grid")
        if cfg.km == 60 and os.path.exists(vg):
            cfg = cfg.with_(vert_grid="file", vert_grid_file=vg)
        ovf = os.path.join(templates, "gx1v7_overflow")
        if (cfg.nx, cfg.ny) == (320, 384) and os.path.exists(ovf):
            cfg = cfg.with_(overflows=it.read_overflows(ovf))
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg


def get_production_menu_mini(dtype: str = "float32",
                             tol: float = 1.0e-4, **overrides) -> ModelConfig:
    """The flagship physics menu (KPP with the horizontally-varying
    background, GM bfre + transition layer, upwind3, tidal mixing,
    submesoscale, chlorophyll shortwave, frazil ice, f64-grade elliptic
    solve) at the ``mini`` grid's dimensions: the production code path at a
    size that compiles and steps in seconds on any device."""
    cfg = get_config("mini").with_(
        dtype=dtype,
        tadvect="upwind3",
        vmix="kpp", kpp_lhoriz_varying_bckgrnd=True, bckgrnd_vdc2=0.0,
        kpp_ldbl_diff=True, kpp_lshort_wave=True,
        hmix_tracer="gm", gm_kappa_isop_type="bfre",
        gm_kappa_thic_type="bfre", gm_transition_layer=True,
        ltidal_mixing=True, tidal_energy_const=1.0e-3,
        lsubmeso=True, sw_absorption="chlorophyll", chl_option="const",
        liceform=True,
        solver=SolverConfig(choice="ChronGear",
                            convergence_criterion=tol,
                            max_iterations=100 if tol >= 1e-6 else 1000,
                            convergence_check_freq=5,
                            solve_dtype="float64"))
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg
