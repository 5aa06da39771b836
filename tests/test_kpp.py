"""KPP vertical mixing tests: finiteness, bounds, physical behavior of the
boundary-layer depth, and an end-to-end model run."""

import numpy as np
import jax.numpy as jnp
import pytest

from pop2_tpu import kpp
from pop2_tpu.config import get_config
from pop2_tpu.grid import build_grid, grid_bc
from pop2_tpu.model import Model


@pytest.fixture(scope="module")
def kcfg():
    # km=20 internal profile (dz1 = 25 m): the boundary layer spans several
    # levels, so the non-local term has room to act (on the 8-level uniform
    # mini grid the BL is one 687-m cell and ghat is legitimately zero)
    return get_config("mini").with_(vmix="kpp", km=20, vert_grid="internal",
                                    kpp_lcheckekmo=False)


@pytest.fixture(scope="module")
def kgrid(kcfg):
    return build_grid(kcfg)


def _profile(kcfg, kgrid, stratified=True, seed=0):
    rng = np.random.RandomState(seed)
    km, ny, nx = kcfg.km, kcfg.ny, kcfg.nx
    kmask = np.asarray(kgrid.kmask_t)
    if stratified:
        zt = np.asarray(kgrid.vgrid.zt)
        T = 15.0 - 3.0 * (zt / zt[-1])[:, None, None]
    else:
        T = np.full((km, 1, 1), 10.0)
    T = np.broadcast_to(T, (km, ny, nx)).copy()
    T += 1e-5 * rng.randn(km, ny, nx)
    S = np.full((km, ny, nx), 0.0347)
    tr = np.stack([T * kmask, S * kmask])
    return jnp.asarray(tr)


def test_buoydiff_stratified_positive(kcfg, kgrid):
    st = kpp.build_statics(kcfg, kgrid)
    tr = _profile(kcfg, kgrid)
    dbloc, dbsfc = kpp.buoydiff(kcfg, kgrid, st, tr)
    dbloc = np.asarray(dbloc)
    kmask = np.asarray(kgrid.kmask_t)
    below = np.concatenate([kmask[1:], np.zeros_like(kmask[:1])])
    # stable stratification: local buoyancy difference positive in interior
    assert (dbloc[below] > -1e-6).mean() > 0.99
    assert np.isfinite(dbloc).all() and np.isfinite(np.asarray(dbsfc)).all()


def test_wscale_neutral_limit():
    # at zero buoyancy forcing, wm = ws = vonkar*ustar
    wm, ws = kpp.wscale(jnp.asarray(0.1), jnp.asarray(1000.0),
                        jnp.asarray(1.0), jnp.asarray(0.0))
    np.testing.assert_allclose(float(wm), 0.4, rtol=1e-6)
    np.testing.assert_allclose(float(ws), 0.4, rtol=1e-6)


def test_kpp_coeffs_finite_and_deepening(kcfg, kgrid):
    st = kpp.build_statics(kcfg, kgrid)
    bc = grid_bc(kcfg)
    km, ny, nx = kcfg.km, kcfg.ny, kcfg.nx
    tr = _profile(kcfg, kgrid)
    u = jnp.zeros((km, ny, nx))
    v = jnp.zeros((km, ny, nx))
    smft = jnp.zeros((2, ny, nx)).at[0].set(
        1.0 * jnp.asarray(np.asarray(kgrid.RCALCT)))
    stf_cool = jnp.zeros((2, ny, nx)).at[0].set(
        -5e-3 * jnp.asarray(np.asarray(kgrid.RCALCT)))  # ~200 W/m^2 cooling
    stf_zero = jnp.zeros((2, ny, nx))
    qsw = jnp.zeros((ny, nx))

    out_neutral = kpp.kpp_coeffs(kcfg, kgrid, bc, st, tr, u, v,
                                 stf_zero, qsw, smft, 1000.0, 1000.0)
    out_cooling = kpp.kpp_coeffs(kcfg, kgrid, bc, st, tr, u, v,
                                 stf_cool, qsw, smft, 1000.0, 1000.0)

    for out in (out_neutral, out_cooling):
        assert np.isfinite(np.asarray(out.vdc)).all()
        assert np.isfinite(np.asarray(out.vvc)).all()
        assert np.asarray(out.vdc).min() >= 0.0
        assert np.asarray(out.vvc).min() >= 0.0
        hblt = np.asarray(out.hblt)
        ocean = np.asarray(kgrid.RCALCT) > 0
        zt = np.asarray(kgrid.vgrid.zt)
        assert (hblt[ocean] >= zt[0] - 1e-6).all()
        assert (hblt[ocean] <= zt[-1] + 1e-6).all()

    # destabilizing buoyancy flux must deepen the boundary layer on average
    ocean = np.asarray(kgrid.RCALCT) > 0
    h_n = np.asarray(out_neutral.hblt)[ocean].mean()
    h_c = np.asarray(out_cooling.hblt)[ocean].mean()
    assert h_c > h_n

    # non-local term active only under unstable forcing
    assert np.abs(np.asarray(out_neutral.ghat_src)).max() < 1e-20
    assert np.abs(np.asarray(out_cooling.ghat_src)).max() > 0.0


def test_kpp_model_runs_stable():
    m = Model(get_config("mini").with_(vmix="kpp"))
    st = m.initial_state()
    for _ in range(30):
        st, _ = m.advance(st)
    dd = m.diagnostics(st)
    assert np.isfinite(dd["KE"]) and dd["KE"] < 100.0
    # tracer conservation
    assert abs(dd["SALT_mean"] - 34.7278125) < 1e-4


def test_kpp_lshort_wave_radiative_bldepth(kcfg, kgrid):
    """lshort_wave (vmix_kpp.F90:2387-2416): penetrating shortwave reduces
    the destabilizing surface buoyancy forcing at depth, so with strong SW
    heating the boundary layer under cooling STF must shoal vs the
    no-radiative case."""
    cfg_sw = kcfg.with_(kpp_lshort_wave=True, sw_absorption="jerlov")
    st = kpp.build_statics(kcfg, kgrid)
    bc = grid_bc(kcfg)
    km, ny, nx = kcfg.km, kcfg.ny, kcfg.nx
    tr = _profile(kcfg, kgrid)
    u = jnp.zeros((km, ny, nx))
    v = jnp.zeros((km, ny, nx))
    rcalct = jnp.asarray(np.asarray(kgrid.RCALCT))
    smft = jnp.zeros((2, ny, nx)).at[0].set(1.0 * rcalct)
    stf_cool = jnp.zeros((2, ny, nx)).at[0].set(-5e-3 * rcalct)
    qsw = 1.0e-2 * rcalct  # strong penetrating shortwave (~400 W/m^2)

    out_off = kpp.kpp_coeffs(kcfg, kgrid, bc, st, tr, u, v,
                             stf_cool, qsw, smft, 1000.0, 1000.0)
    out_sw = kpp.kpp_coeffs(cfg_sw, kgrid, bc, st, tr, u, v,
                            stf_cool, qsw, smft, 1000.0, 1000.0)
    ocean = np.asarray(kgrid.RCALCT) > 0
    assert np.isfinite(np.asarray(out_sw.vdc)).all()
    h_off = np.asarray(out_off.hblt)[ocean].mean()
    h_sw = np.asarray(out_sw.hblt)[ocean].mean()
    assert h_sw < h_off

    # chlorophyll transmission path also runs and stays finite
    cfg_chl = kcfg.with_(kpp_lshort_wave=True, sw_absorption="chlorophyll")
    out_chl = kpp.kpp_coeffs(cfg_chl, kgrid, bc, st, tr, u, v,
                             stf_cool, qsw, smft, 1000.0, 1000.0)
    assert np.isfinite(np.asarray(out_chl.hblt)).all()


def test_kpp_lcheckekmo_limits_bldepth(kcfg, kgrid):
    """lcheckekmo (vmix_kpp.F90:2425-2453, 2676-2689): under stable forcing
    the Ekman depth ~ cekman*ustar/|f| caps the boundary-layer depth, so
    with weak wind at high latitude HBLT must not exceed the limit by much
    (smoothing happens after the cap)."""
    cfg_ek = kcfg.with_(kpp_lcheckekmo=True)
    st = kpp.build_statics(kcfg, kgrid)
    bc = grid_bc(kcfg)
    km, ny, nx = kcfg.km, kcfg.ny, kcfg.nx
    # well-mixed (unstratified) column: without limits the bulk Ri never
    # crosses Ricr and HBLT bottoms out
    tr = _profile(kcfg, kgrid, stratified=False)
    u = jnp.zeros((km, ny, nx))
    v = jnp.zeros((km, ny, nx))
    rcalct = jnp.asarray(np.asarray(kgrid.RCALCT))
    smft = jnp.zeros((2, ny, nx)).at[0].set(0.01 * rcalct)  # weak wind
    stf_warm = jnp.zeros((2, ny, nx)).at[0].set(5e-3 * rcalct)  # stable
    qsw = jnp.zeros((ny, nx))

    out_off = kpp.kpp_coeffs(kcfg, kgrid, bc, st, tr, u, v,
                             stf_warm, qsw, smft, 1000.0, 1000.0)
    out_ek = kpp.kpp_coeffs(cfg_ek, kgrid, bc, st, tr, u, v,
                            stf_warm, qsw, smft, 1000.0, 1000.0)
    assert np.isfinite(np.asarray(out_ek.hblt)).all()
    assert np.isfinite(np.asarray(out_ek.vdc)).all()
    ocean = np.asarray(kgrid.RCALCT) > 0
    h_off = np.asarray(out_off.hblt)[ocean]
    h_ek = np.asarray(out_ek.hblt)[ocean]
    # the limit can only shoal the boundary layer
    assert (h_ek <= h_off + 1e-6).all()
    assert h_ek.mean() < h_off.mean()


def test_horiz_varying_background_structure():
    """Jochum (2009) horizontally-varying background diffusivity
    (vmix_kpp.F90:544-632): equatorial floor ~ bckgrnd_vdc_eq, PSI peaks
    near +-28.9 deg, vdc1 plateau poleward, Banda Sea override."""
    import numpy as np
    from pop2_tpu import kpp as kpp_mod
    from pop2_tpu.config import get_config
    from pop2_tpu.grid import build_grid
    from pop2_tpu import constants as c

    cfg = get_config("mini").with_(kpp_lhoriz_varying_bckgrnd=True,
                                   bckgrnd_vdc2=0.0)
    grid = build_grid(cfg)
    vdc = np.asarray(kpp_mod.background_vdc(cfg, grid))[0]   # (ny, nx)
    lat = np.asarray(grid.TLAT) * c.RADIAN

    lon = np.asarray(grid.TLON) * c.RADIAN
    lon = np.where(lon < 0, lon + 360.0, lon)
    eq_band = (np.abs(lat) < 5.0) & ((lon < 103.0) | (lon > 142.0))
    if not eq_band.any():                   # mini grid may not span 5S-5N
        eq_band = np.abs(lat) <= np.abs(lat).min() + 1.0
    eq = vdc[eq_band]
    # near the equator (outside the Banda boxes): Gregg floor + ramped vdc1
    assert eq.max() < cfg.bckgrnd_vdc_eq + cfg.bckgrnd_vdc + 0.05
    # Banda Sea override present somewhere in the tropics
    banda = (lat < -1.0) & (lat > -8.3) & (lon > 103.0) & (lon < 142.0)
    if banda.any():
        assert np.isclose(vdc[banda].max(), cfg.bckgrnd_vdc_ban)
    # poleward plateau ~ vdc1 + eq floor
    pole = vdc[np.abs(lat) > 60.0]
    if pole.size:
        assert np.allclose(pole, cfg.bckgrnd_vdc + cfg.bckgrnd_vdc_eq,
                           atol=1e-3)
    # PSI bands exceed the equatorial floor
    band = (np.abs(lat) > 26.0) & (np.abs(lat) < 32.0)
    if band.any():
        assert vdc[band].max() > eq.max()

    # guard: vdc2 must be zero with the horizontal structure
    import pytest
    with pytest.raises(ValueError):
        kpp_mod.background_vdc(
            cfg.with_(bckgrnd_vdc2=0.05), grid)


def test_horiz_varying_background_model_runs():
    import numpy as np
    from pop2_tpu.config import get_config
    from pop2_tpu.model import Model
    cfg = get_config("mini").with_(vmix="kpp", kpp_lhoriz_varying_bckgrnd=True,
                                   bckgrnd_vdc2=0.0)
    m = Model(cfg)
    st = m.initial_state()
    for _ in range(3):
        st, _ = m.advance(st)
    assert np.isfinite(m.diagnostics(st)["KE"])


def _dot_precisions(jaxpr):
    """``precision`` of every dot_general in a jaxpr, sub-jaxprs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if hasattr(sub, "eqns"):
                    found += _dot_precisions(sub)
                elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    found += _dot_precisions(sub.jaxpr)
    return found


@pytest.mark.parametrize("stage", ["buoydiff", "kpp_coeffs"])
def test_kpp_contractions_use_highest_precision(stage, kcfg, kgrid):
    """KPP's contractions over km (RHOAVG, the reference velocities) ask
    for full float32 precision, so a GPU never runs them in TF32."""
    import jax
    st = kpp.build_statics(kcfg, kgrid)
    tr = _profile(kcfg, kgrid)
    if stage == "buoydiff":
        fn = lambda t: kpp.buoydiff(kcfg, kgrid, st, t)  # noqa: E731
        args = (tr,)
    else:
        km, ny, nx = kcfg.km, kcfg.ny, kcfg.nx
        z3, z2 = jnp.zeros((km, ny, nx)), jnp.zeros((2, ny, nx))

        def fn(t, u):
            return kpp.kpp_coeffs(kcfg, kgrid, grid_bc(kcfg), st, t, u, u,
                                  z2, z2[0], z2, 1000.0, 1000.0)
        args = (tr, z3)
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions, "no contraction found"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p is not None and all(q == highest for q in p), p
