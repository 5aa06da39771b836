"""End-to-end step tests on the mini grid: stability, conservation,
determinism, exact restart (the reference's ERS test class, SURVEY.md §4.2).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pop2_tpu.config import get_config
from pop2_tpu.model import Model


@pytest.fixture(scope="module")
def mini_model():
    return Model(get_config("mini"))


def _tracer_integral(model, state):
    """Thickness-weighted tracer integrals including the variable surface
    layer thickness (dz1 + psurf/g)."""
    g = model.grid
    from pop2_tpu import constants as const
    dz = np.asarray(g.vgrid.dz)
    kmask = np.asarray(g.kmask_t)
    tarea = np.asarray(g.TAREA)
    tr = np.asarray(state.tracer_cur)
    psurf = np.asarray(state.psurf_cur)
    thick = dz[None, :, None, None] * np.ones_like(tr)
    thick[:, 0] = dz[0] + psurf[None] / const.GRAV
    return (tr * thick * tarea[None, None] * kmask[None]).sum(axis=(1, 2, 3))


def test_spinup_stable_and_conservative(mini_model):
    m = mini_model
    st = m.initial_state()
    tot0 = _tracer_integral(m, st)
    for _ in range(60):
        st, d = m.advance(st)
    dd = m.diagnostics(st)
    assert np.isfinite(dd["KE"]) and 0 < dd["KE"] < 100.0
    tot = _tracer_integral(m, st)
    # volume-weighted tracer content conserved to roundoff-level drift
    rel = np.abs(tot - tot0) / np.abs(tot0)
    assert rel.max() < 1e-7, rel


def test_avg_step_runs(mini_model):
    m = mini_model
    st = m.initial_state()
    # run past an averaging step (time_mix_freq=17)
    for _ in range(20):
        st, _ = m.advance(st)
    assert np.isfinite(m.diagnostics(st)["KE"])


def test_determinism(mini_model):
    m = mini_model
    st1 = m.initial_state()
    for _ in range(5):
        st1, _ = m.advance(st1)
    st2 = m.initial_state()
    for _ in range(5):
        st2, _ = m.advance(st2)
    np.testing.assert_array_equal(np.asarray(st1.tracer_cur),
                                  np.asarray(st2.tracer_cur))
    np.testing.assert_array_equal(np.asarray(st1.u_cur),
                                  np.asarray(st2.u_cur))


def test_exact_restart(tmp_path, mini_model):
    """ERS-class test: run 2N steps straight vs N + restart + N — bitwise."""
    from pop2_tpu.io import restart as rst
    m = mini_model
    cfg = m.cfg

    st = m.initial_state()
    for _ in range(6):
        st, _ = m.advance(st)
    # canonicalize through host at the checkpoint step: a restart file
    # always resumes from the host representation, so the straight branch
    # does too, which keeps the bitwise comparison well-posed on any backend
    import jax.tree_util as jtu
    st = jtu.tree_map(lambda a: jnp.asarray(np.asarray(a)), st)
    straight = st
    for _ in range(4):
        straight, _ = m.advance(straight)

    # rerun to the checkpoint point (model counter must match)
    st = m.initial_state()
    for _ in range(6):
        st, _ = m.advance(st)
    path = rst.write_restart(str(tmp_path / "chkpt"), st, m.nsteps_total, cfg)
    st2, nsteps = rst.read_restart(path, cfg)

    # bitwise resume with the same compiled executable (the reference's ERS
    # tests rerun one binary; a compiled jit step is the analogue — separate
    # compilations of the same program are not guaranteed bit-identical by
    # XLA's autotuner)
    m.nsteps_total = nsteps
    resumed = st2
    for _ in range(4):
        resumed, _ = m.advance(resumed)

    np.testing.assert_array_equal(np.asarray(straight.tracer_cur),
                                  np.asarray(resumed.tracer_cur))
    np.testing.assert_array_equal(np.asarray(straight.u_cur),
                                  np.asarray(resumed.u_cur))
    np.testing.assert_array_equal(np.asarray(straight.psurf_cur),
                                  np.asarray(resumed.psurf_cur))

    # fresh Model instance (new jit executables): resume must agree to
    # fp64 recompile-drift tolerance
    m2 = Model(cfg, grid=m.grid)
    m2.nsteps_total = nsteps
    resumed2 = st2
    for _ in range(4):
        resumed2, _ = m2.advance(resumed2)
    np.testing.assert_allclose(np.asarray(straight.tracer_cur),
                               np.asarray(resumed2.tracer_cur),
                               rtol=1e-12, atol=1e-12)


def test_first_step_is_euler(mini_model):
    assert mini_model.step_flags(1) == (False, False)
    assert mini_model.step_flags(2) == (True, False)
    freq = mini_model.cfg.time.time_mix_freq
    assert mini_model.step_flags(freq) == (True, True)


def test_restart_read_fallbacks(tmp_path):
    """io_read_fallback_mod analogue (source/io_read_fallback_mod.F90):
    resuming a checkpoint written with FEWER tracers pads the tracer axes
    from the template and re-primes the Robert-filter memory; a missing
    state field falls back to the template value."""
    from pop2_tpu.config import get_config
    from pop2_tpu.io import restart as rst
    from pop2_tpu.model import Model

    cfg2 = get_config("mini")                     # nt = 2
    m2 = Model(cfg2)
    st = m2.initial_state()
    for _ in range(3):
        st, _ = m2.advance(st)
    path = rst.write_restart(str(tmp_path / "old"), st, m2.nsteps_total,
                             cfg2)

    # resume under a 3-tracer config (iage added)
    cfg3 = cfg2.with_(nt=3, passive_tracers=("iage",))
    m3 = Model(cfg3)
    tmpl = m3.initial_state()
    st3, nsteps = rst.read_restart(path, cfg3, template=tmpl)
    assert st3.tracer_cur.shape[0] == 3
    np.testing.assert_array_equal(np.asarray(st3.tracer_cur[:2]),
                                  np.asarray(st.tracer_cur))
    np.testing.assert_array_equal(np.asarray(st3.tracer_cur[2]),
                                  np.asarray(tmpl.tracer_cur[2]))
    assert float(st3.rf_s_prev_valid) == 0.0     # filter memory re-primed
    # strict read (no template) must refuse the nt mismatch
    import pytest
    with pytest.raises(ValueError):
        rst.read_restart(path, cfg3)
    # the resumed model steps
    m3.nsteps_total = nsteps
    st3, _ = m3.advance(st3)
    assert np.isfinite(np.asarray(st3.tracer_cur)).all()

    # missing-field fallback: simulate an older checkpoint without the
    # Robert-filter fields
    data = dict(np.load(path))
    for k in ("rf_s_prev", "rf_s_prev_valid"):
        del data[k]
    p2 = str(tmp_path / "older.npz")
    np.savez_compressed(p2, **data)
    import shutil
    shutil.copy(path + ".json", p2 + ".json")
    with pytest.raises(KeyError):
        rst.read_restart(p2, cfg2)
    st_fb, _ = rst.read_restart(p2, cfg2, template=m2.initial_state())
    np.testing.assert_array_equal(np.asarray(st_fb.tracer_cur),
                                  np.asarray(st.tracer_cur))
    assert st_fb.rf_s_prev.shape == (2,)
