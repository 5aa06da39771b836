"""Parsers for the reference's real per-grid input files
(io/input_templates.py) + the section-transport diagnostic they drive."""

import os

import numpy as np
import pytest

from pop2_tpu.io import input_templates as it

REF = "/root/reference/input_templates"
have_ref = os.path.isdir(REF)
needs_ref = pytest.mark.skipif(not have_ref,
                               reason="reference input_templates absent")


@needs_ref
def test_vert_grid_gx1v7():
    """The real gx1v7 60-level dz column: 16 x 10 m surface layers,
    monotone growth to ~250 m at depth, total depth ~5500 m."""
    dz = it.read_vert_grid(f"{REF}/gx1v7_vert_grid")
    assert dz.shape == (60,)
    assert np.allclose(dz[:16], 1000.0)      # 10 m surface layers (cm)
    assert (np.diff(dz) >= -1e-6).all()      # monotone non-decreasing
    assert 5.0e5 < dz.sum() < 6.0e5          # ~5500 m total
    # byte-identical reuse through the grid builder
    from pop2_tpu.io import grid_files
    dz2 = grid_files.read_vert_grid(f"{REF}/gx1v7_vert_grid", 60)
    assert np.array_equal(dz, dz2)


@needs_ref
def test_vert_grid_drives_model_grid():
    """vert_grid='file' on the real gx1v7 column reproduces the file's
    own zt/zw columns (they are derivable from dz)."""
    from pop2_tpu.config import get_config
    from pop2_tpu.grid import build_grid
    path = f"{REF}/gx1v7_vert_grid"
    cfg = get_config("test").with_(km=60, vert_grid="file",
                                   vert_grid_file=path)
    g = build_grid(cfg)
    # file columns 2/3 are zt/zw in m; ours are cm
    rows = np.loadtxt(path)
    assert np.allclose(np.asarray(g.vgrid.zt), rows[:, 1] * 100.0,
                       rtol=1e-6)
    assert np.allclose(np.asarray(g.vgrid.zw), rows[:, 2] * 100.0,
                       rtol=1e-6)


@needs_ref
def test_depth_accel_files_are_unity():
    """Every shipped depth_accel profile is 1.0 (and laccel defaults to
    .false., bld/namelist_files/namelist_defaults_pop.xml:67) — i.e.
    depth acceleration is OFF in production; reading the real file must
    reproduce that."""
    for grid in ("gx1v7", "gx3v7", "tx0.1v3"):
        da = it.read_depth_accel(f"{REF}/{grid}_depth_accel")
        assert (da == 1.0).all()


@needs_ref
def test_region_ids_gx1v7():
    regs = it.read_region_ids(f"{REF}/gx1v7_region_ids")
    assert len(regs) == 13
    names = [r.name for r in regs]
    assert "Southern Ocean" in names and "Black Sea" in names
    ms = [r for r in regs if r.is_marginal_sea]
    assert {r.name for r in ms} == {"Red Sea", "Baltic Sea", "Black Sea"}
    red = next(r for r in ms if r.name == "Red Sea")
    assert red.lat == 14.0 and red.lon == 47.0 and red.area == 3.0e15


@needs_ref
def test_transport_contents_gx1v7():
    secs = it.read_transport_contents(f"{REF}/gx1v7_transport_contents")
    assert len(secs) == 11
    drake = secs[0]
    assert drake.name == "Drake Passage" and drake.orient == "merid"
    assert (drake.imin, drake.imax) == (296, 296)
    assert (drake.jmin, drake.jmax) == (23, 46)
    assert (drake.kmin, drake.kmax) == (0, 59)


@needs_ref
def test_tavg_contents_gx1v7():
    rows = it.read_tavg_contents(f"{REF}/gx1v7_tavg_contents")
    assert len(rows) == 101
    names = [n for _, n in rows]
    assert "TEMP" in names and "KAPPA_ISOP" in names and "QFLUX" in names
    # streams 1 (monthly), 2 (daily), 3 (annual) all appear; commented
    # (#/!) rows are excluded
    assert {s for s, _ in rows} == {1, 2, 3}
    assert sum(1 for s, _ in rows if s == 1) == 94
    assert "HMXL" not in [n for s, n in rows if s == 2]  # '# 2 HMXL_2' off


def test_section_transport_uniform_flow():
    """A uniform zonal flow through a meridional section yields the
    analytic transport sum(U*DYU*dz) over the section faces."""
    import jax.numpy as jnp
    from pop2_tpu import constants as const
    from pop2_tpu import diagnostics as diag
    from pop2_tpu.config import get_config
    from pop2_tpu.model import Model

    cfg = get_config("mini")
    m = Model(cfg)
    st = m.initial_state()
    u0 = 10.0  # cm/s
    u = jnp.where(m.grid.kmask_u, u0, 0.0)
    st = st.replace(u_cur=u)

    sec = it.TransportSection(imin=5, imax=5, jmin=3, jmax=8,
                              kmin=0, kmax=cfg.km - 1, orient="merid",
                              name="test")
    mass, heat, salt = diag.section_transport(cfg, m.grid, st, sec)

    from pop2_tpu.grid import thickness_u
    dzu = np.asarray(thickness_u(cfg, m.grid))
    uh = u0 * np.asarray(m.grid.DYU)[None] * dzu * np.asarray(
        m.grid.kmask_u)
    expect = 0.5 * (uh[:, 3:9, 5] + uh[:, 2:8, 5]).sum() * const.MASS_TO_SV
    assert np.isclose(mass, expect, rtol=1e-12)
    # heat transport carries the face-mean temperature
    assert heat != 0.0


@needs_ref
def test_tavg_registry_covers_real_contents():
    """Every active field in the reference's gx1v7 tavg contents files
    (monthly + high-frequency) is registered (round-3 verdict #6)."""
    from pop2_tpu import tavg
    for fname in ("gx1v7_tavg_contents", "gx1v7_tavg_contents_high_freq"):
        rows = it.read_tavg_contents(f"{REF}/{fname}")
        missing = sorted({n for _, n in rows if n not in tavg.FIELDS})
        assert not missing, f"{fname}: unregistered fields {missing}"


@needs_ref
@pytest.mark.slow
def test_production_config_assembles():
    """get_production_config attaches the real gx1v7 data and the full
    model statics build at production dims (grid, overflow statics with
    sidewall momentum tables, KPP statics)."""
    from pop2_tpu import overflows as ovf
    from pop2_tpu.grid import build_grid
    from pop2_tpu.production import get_production_config

    cfg = get_production_config()
    assert [s.name for s in cfg.overflows] == [
        "Denmark Strait", "Faroe Bank Channel", "Ross Sea", "Weddell Sea"]
    assert cfg.vert_grid == "file"
    assert cfg.gm_kappa_isop_type == "bfre" and cfg.gm_transition_layer
    assert cfg.solver.convergence_criterion == 1.0e-13
    assert cfg.solver.solve_dtype == "float64"

    grid = build_grid(cfg)
    assert float(np.asarray(grid.vgrid.zw)[-1]) == pytest.approx(
        5.49999e5, rel=1e-3)
    st = ovf.build_statics(cfg, grid)
    assert st.mom_u["j"].shape[0] > 0 and st.mom_v["j"].shape[0] > 0
    assert st.zren is not None and float(st.zren.min()) <= 1.0
