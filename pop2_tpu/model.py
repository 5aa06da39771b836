"""Top-level model driver: wiring of grid, forcing, state, and the jitted
step, plus the host-side time manager.

Replaces the reference's driver layer (``drivers/mct/ocn_comp_mct.F90`` run
loop + ``source/time_management.F90`` switches) for standalone runs. The time
manager here implements the 'avg' time-mixing policy: Euler-forward first
step, leapfrog afterwards, averaging filter every ``time_mix_freq`` steps
(source/time_management.F90:2157-2175).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pop2_tpu import constants as const
from pop2_tpu import eos, solvers, step as step_mod
from pop2_tpu.barotropic import diagonal_correction
from pop2_tpu.config import ModelConfig
from pop2_tpu.forcing import Forcing, analytic_forcing
from pop2_tpu.grid import Grid, build_grid, grid_bc
from pop2_tpu.state import State, initial_state


class Model:
    """Standalone ocean model instance."""

    def __init__(self, cfg: ModelConfig, grid: Optional[Grid] = None):
        if cfg.overflows and grid is None:
            # reference contract: the overflow point data must agree with
            # the topography (init_overflows_kmt counts KMT /= korg as
            # errors and aborts, source/overflows.F90:1196-1275). Strict
            # mode reproduces the abort; otherwise inconsistent overflows
            # are deactivated with a warning — an inconsistent conduit
            # (e.g. the real gx1v7 point data on an internally generated
            # topography) turns the prescribed circuit into an unstable
            # forcing (round-5: exponential blowup at the Ross/Weddell
            # points by step 20 of the flagship bench).
            from pop2_tpu import overflows as ovf_mod
            cfg = ovf_mod.validate_geometry(cfg)
        self.cfg = cfg
        self.grid = grid if grid is not None else build_grid(cfg)
        self.bc = grid_bc(cfg)
        self.ts_range = (eos.build_ts_range(np.asarray(self.grid.vgrid.zt),
                                            cfg.jnp_dtype)
                         if cfg.state_range_opt == "enforce" else None)
        self.forcing = analytic_forcing(cfg, self.grid)
        self.nsteps_total = 0
        from pop2_tpu.time_management import TimeManager
        self.time_manager = TimeManager(
            cfg.time.dtt, start_year=cfg.time.start_year,
            start_month=cfg.time.start_month, start_day=cfg.time.start_day,
            allow_leapyear=cfg.time.allow_leapyear)
        self.kpp_statics = None
        if cfg.vmix == "kpp":
            from pop2_tpu import kpp as kpp_mod
            self.kpp_statics = kpp_mod.build_statics(cfg, self.grid)
        self.sw_profile = None
        if cfg.sw_absorption == "jerlov":
            from pop2_tpu import sw_absorption as sw_mod
            self.sw_profile = sw_mod.absorb_profile(cfg, self.grid)
        self.passive = None
        if cfg.passive_tracers:
            from pop2_tpu.passive_tracers import PassiveTracers
            self.passive = PassiveTracers(cfg, cfg.passive_tracers)
        self.ovf_statics = None
        if cfg.overflows:
            from pop2_tpu import overflows as ovf_mod
            self.ovf_statics = ovf_mod.build_statics(cfg, self.grid)
            # overflow columns fold into the barotropic operator weights
            # (ovf_solvers_9pt, source/overflows.F90:5515-5728) — must
            # precede the Lanczos eigenvalue prep below
            self.grid = ovf_mod.solvers_9pt(cfg, self.grid)
        # per-model dispatch mesh for the shard_map'ed Thomas kernel: derived
        # from the config (never module-global state, so models with
        # different meshes coexist). Entered as a scope at trace time below.
        self._mesh = None
        if cfg.mesh_shape != (1, 1):
            from pop2_tpu.parallel import mesh as pmesh
            self._mesh = pmesh.make_mesh(cfg.mesh_shape)
        self.tavg_streams = []
        self.history_streams = []
        self._tavg_outdir = "."
        self.tavg_files = []
        self.precond = None
        if (cfg.solver.preconditioner.lower() == "file"
                and cfg.solver.preconditioner_file):
            self.precond = solvers.load_precond(
                cfg.solver.preconditioner_file, cfg.jnp_dtype)
        elif cfg.solver.preconditioner.lower() == "fspai":
            # factored SPAI (SPD by construction) on the leapfrog operator
            op_lf = solvers.make_operator(
                self.grid, diagonal_correction(cfg, self.grid, True))
            self.precond = solvers.build_fspai9(cfg, op_lf)
        elif cfg.solver.preconditioner.lower() == "spai":
            # generated-at-init SPAI stencil (the reference's 'file'
            # preconditioner with the coefficients built in-process,
            # solvers.build_spai9); built from the leapfrog operator —
            # the Euler first step reuses it (any SPD M is valid)
            op_lf = solvers.make_operator(
                self.grid, diagonal_correction(cfg, self.grid, True))
            self.precond = solvers.build_spai9(cfg, op_lf)
        # PCSI eigenvalue bounds are prepared once per leapfrog flag. This is
        # valid because diagonal_correction is a pure function of
        # (cfg, grid, leapfrog) — the reference re-preps every solve
        # (POP_SolversPrep, source/POP_SolversMod.F90:181-270) because its
        # correction can vary in time. If diagonal_correction ever gains a
        # state dependence, re-prep here per step (guarded by
        # tests/test_solvers.py::test_pcsi_eigs_match_step_operator).
        self._pcsi_eigs: Dict[bool, Tuple[float, float]] = {}
        if cfg.solver.choice.lower() == "pcsi":
            for leapfrog in (False, True):
                op = solvers.make_operator(
                    self.grid, diagonal_correction(cfg, self.grid, leapfrog))
                if self.precond is not None:
                    self._pcsi_eigs[leapfrog] = solvers.pcg_lanczos_eigs(
                        cfg, op, self.bc, self.precond)
                else:
                    self._pcsi_eigs[leapfrog] = solvers.lanczos_eigs(
                        cfg, op, self.bc)

        from pop2_tpu import tridiag_pallas

        @functools.partial(jax.jit, static_argnames=("leapfrog", "avg_ts",
                                                     "with_extras"))
        def _step(state, forcing, leapfrog, avg_ts, with_extras=False):
            with tridiag_pallas.dispatch_mesh(self._mesh):
                return step_mod.step(cfg, self.grid, self.bc, self.ts_range,
                                     state, forcing, leapfrog, avg_ts,
                                     self._pcsi_eigs.get(leapfrog),
                                     precond=self.precond,
                                     kpp_statics=self.kpp_statics,
                                     sw_profile=self.sw_profile,
                                     passive=self.passive,
                                     ovf_statics=self.ovf_statics,
                                     with_extras=with_extras)

        self._step = _step
        self._scan_tavg_fn = None  # built lazily per tavg-stream set

        @functools.partial(jax.jit, static_argnames=("nsteps",))
        def _scan_leapfrog(state, forcing, nsteps):
            """nsteps plain leapfrog steps fused in one executable — the
            whole-run lax.scan pattern (SURVEY.md §7.1) that amortizes
            host->device dispatch."""
            def body(st, _):
                st, diags = step_mod.step(
                    cfg, self.grid, self.bc, self.ts_range, st, forcing,
                    leapfrog=True, avg_ts=False,
                    pcsi_eigs=self._pcsi_eigs.get(True),
                    precond=self.precond,
                    kpp_statics=self.kpp_statics,
                    sw_profile=self.sw_profile, passive=self.passive,
                    ovf_statics=self.ovf_statics)
                return st, diags
            with tridiag_pallas.dispatch_mesh(self._mesh):
                state, diags = jax.lax.scan(body, state, None, length=nsteps)
            return state, jax.tree_util.tree_map(lambda a: a[-1], diags)

        self._scan_leapfrog = _scan_leapfrog

    # -- time manager (source/time_management.F90:2157-2234) ----------------
    def step_flags(self, nsteps_total: int) -> Tuple[bool, bool]:
        """(leapfrog, avg_ts) for 1-based step number ``nsteps_total``."""
        leapfrog = nsteps_total != 1
        avg_ts = False  # robert filtering happens inside every step
        tm = self.cfg.time
        if tm.time_mix_opt == "avg":
            avg_ts = (nsteps_total % tm.time_mix_freq == 0
                      and nsteps_total > 1)
        elif tm.time_mix_opt == "avgfit":
            # averaging at step 2 of each interval and every time_mix_freq
            # steps within it, never on the interval's last step
            # (set_switches, source/time_management.F90:2195-2213)
            _, _, n, _ = tm.avgfit_params()
            nsti = (nsteps_total - 1) % n + 1
            avg_ts = (nsteps_total > 1
                      and (nsti == 2 or (nsti % tm.time_mix_freq == 0
                                         and nsti != n)))
        return leapfrog, avg_ts

    def initial_state(self) -> State:
        self.nsteps_total = 0
        self.time_manager.reset()
        return initial_state(self.cfg, self.grid, passive=self.passive)

    def _register_stream_flag(self, stream, kind: str, prefix: str,
                              freq_opt, freq: int):
        """Calendar-based scheduling: register a time flag for the stream
        (each reference stream owns a time flag, source/tavg.F90:569-585)."""
        if freq_opt is None:
            stream.flag_name = None
            return
        stream.flag_name = f"{kind}:{prefix}"
        self.time_manager.init_time_flag(stream.flag_name, freq_opt, freq,
                                         owner=kind)

    def enable_tavg(self, contents, freq_steps: int = 0, outdir: str = ".",
                    prefix: str = "tavg", freq_opt: str = None,
                    freq: int = 1):
        """Add a tavg output stream (source/tavg.F90 stream mechanism).
        Schedule by step count (``freq_steps``) or by calendar frequency
        (``freq_opt`` in nyear/nmonth/nday/nhour/nsecond/nstep + ``freq``)."""
        from pop2_tpu.tavg import TavgStream
        stream = TavgStream(self.cfg, self.grid, contents,
                            freq_steps if freq_opt is None else 10 ** 9,
                            outfile_prefix=prefix)
        self._register_stream_flag(stream, "tavg", prefix, freq_opt, freq)
        self.tavg_streams.append(stream)
        self._tavg_outdir = outdir
        self._scan_tavg_fn = None  # stream set changed; rebuild lazily
        return stream

    def enable_history(self, contents, freq_steps: int = 0,
                       outdir: str = ".", prefix: str = "pop2_tpu.h",
                       freq_opt: str = None, freq: int = 1):
        """Add an instantaneous snapshot stream (source/history.F90)."""
        from pop2_tpu.history import HistoryStream
        stream = HistoryStream(self.cfg, self.grid, contents, freq_steps,
                               outfile_prefix=prefix)
        self._register_stream_flag(stream, "history", prefix, freq_opt, freq)
        self.history_streams.append(stream)
        self._tavg_outdir = outdir
        return stream

    def enable_movie(self, contents, freq_steps: int = 0, outdir: str = ".",
                     level: int = 0, prefix: str = "pop2_tpu.m",
                     freq_opt: str = None, freq: int = 1):
        """Add a 2-D snapshot stream (source/movie.F90)."""
        from pop2_tpu.history import MovieStream
        stream = MovieStream(self.cfg, self.grid, contents, freq_steps,
                             level=level, outfile_prefix=prefix)
        self._register_stream_flag(stream, "movie", prefix, freq_opt, freq)
        self.history_streams.append(stream)
        self._tavg_outdir = outdir
        return stream

    def _stream_due(self, stream) -> bool:
        """Calendar-flag scheduling when the stream registered one
        (time-flag service, source/time_management.F90:2241-3021);
        otherwise step-frequency."""
        flag = getattr(stream, "flag_name", None)
        if flag is not None:
            return self.time_manager.check_time_flag(flag)
        return None

    def _output_driver(self, state: State, forcing: Forcing, extras: dict):
        """Per-step output hook: history -> movie -> tavg
        (output_driver, source/output.F90:53)."""
        from pop2_tpu.tavg import TavgAux
        aux = TavgAux(forcing=forcing, bc=self.bc, **(extras or {}))
        for stream in self.history_streams:
            stream.aux = aux
            due = self._stream_due(stream)
            if due is None:
                due = stream.due(self.nsteps_total)
            if due:
                self.tavg_files.append(
                    stream.write(self._tavg_outdir, state,
                                 self.nsteps_total))
        for stream in self.tavg_streams:
            stream.accumulate(state, aux)
            due = self._stream_due(stream)
            if due is None:
                due = stream.ready
            if due and stream.nsamples > 0:
                self.tavg_files.append(
                    stream.write(self._tavg_outdir, self.nsteps_total))
                stream.reset()

    def advance(self, state: State,
                forcing: Optional[Forcing] = None):
        """Advance one step; returns (state, diagnostics)."""
        forcing = forcing or self.forcing
        self.nsteps_total += 1
        if self.cfg.ltidal_mixing and self.cfg.ltidal_lunar_cycle:
            # 18.6-yr lunar nodal cycle: refresh the tidal energy
            # modulation from the model calendar (tidal_mixing.py LNC)
            from pop2_tpu import tidal_mixing as tm_mod
            year = self.time_manager.calendar.year_fraction
            forcing = forcing.replace(tidal_lnc=jnp.asarray(
                tm_mod.lunar_nodal_modulation(year), self.cfg.jnp_dtype))
        leapfrog, avg_ts = self.step_flags(self.nsteps_total)
        # averaging steps are half steps on the calendar
        # (source/time_management.F90:1854-1858)
        self.time_manager.advance(
            0.5 * self.cfg.time.dtt if avg_ts else None)
        with_output = bool(self.tavg_streams or self.history_streams)
        if with_output:
            state, diags, extras = self._step(state, forcing,
                                              leapfrog=leapfrog,
                                              avg_ts=avg_ts,
                                              with_extras=True)
            self._output_driver(state, forcing, extras)
            return state, diags
        return self._step(state, forcing, leapfrog=leapfrog, avg_ts=avg_ts)

    def run(self, state: State, nsteps: int,
            forcing: Optional[Forcing] = None) -> State:
        for _ in range(nsteps):
            state, _ = self.advance(state, forcing)
        return state

    scan_chunk: int = 8  # fixed fused-segment length (one compile)

    def _make_scan_tavg(self):
        """Build the fused-scan executable that carries the tavg accumulators
        in the scan state (SURVEY.md §5.5: accumulation compiled into the jit
        carry, so output streams never break scan fusion)."""
        from pop2_tpu import tridiag_pallas
        from pop2_tpu.tavg import TavgAux
        cfg = self.cfg
        streams = tuple(self.tavg_streams)

        @functools.partial(jax.jit, static_argnames=("nsteps",))
        def _scan(state, sums, forcing, nsteps):
            def body(carry, _):
                st, sm = carry
                st2, diags, extras = step_mod.step(
                    cfg, self.grid, self.bc, self.ts_range, st, forcing,
                    leapfrog=True, avg_ts=False,
                    pcsi_eigs=self._pcsi_eigs.get(True),
                    precond=self.precond, kpp_statics=self.kpp_statics,
                    sw_profile=self.sw_profile, passive=self.passive,
                    ovf_statics=self.ovf_statics, with_extras=True)
                aux = TavgAux(forcing=forcing, bc=self.bc, **extras)
                sm2 = tuple(s.accum_tree(smi, st2, aux)
                            for s, smi in zip(streams, sm))
                return (st2, sm2), diags
            with tridiag_pallas.dispatch_mesh(self._mesh):
                (state, sums), diags = jax.lax.scan(
                    body, (state, sums), None, length=nsteps)
            return state, sums, jax.tree_util.tree_map(
                lambda a: a[-1], diags)

        return _scan

    def run_compiled(self, state: State, nsteps: int,
                     forcing: Optional[Forcing] = None):
        """Advance ``nsteps``, fusing runs of plain leapfrog steps into
        fixed-size ``lax.scan`` chunks (Euler/averaging steps and chunk
        remainders run individually). Step-frequency tavg streams accumulate
        INSIDE the scan carry; snapshot (history/movie) streams and
        calendar-flag scheduling need host hooks every step and fall back to
        per-step dispatch. Returns (state, last_diags)."""
        forcing = forcing or self.forcing
        host_hooks = (self.history_streams
                      or any(getattr(s, "flag_name", None)
                             for s in self.tavg_streams))
        if host_hooks:
            diags = None
            for _ in range(nsteps):
                state, diags = self.advance(state, forcing)
            return state, diags
        tavg = list(self.tavg_streams)
        if tavg and self._scan_tavg_fn is None:
            self._scan_tavg_fn = self._make_scan_tavg()
        diags = None
        remaining = nsteps
        while remaining > 0:
            nxt = self.nsteps_total + 1
            leapfrog, avg_ts = self.step_flags(nxt)
            # how many consecutive plain-leapfrog steps lie ahead?
            span = 0
            while span < remaining:
                lf, av = self.step_flags(nxt + span)
                if not lf or av:
                    break
                span += 1
            if tavg:
                # never scan across a stream's write boundary
                span = min([span] + [s.freq_steps - s.nsamples
                                     for s in tavg if s.freq_steps > 0])
            if span >= self.scan_chunk:
                nchunks = span // self.scan_chunk
                for _ in range(nchunks):
                    if tavg:
                        sums = tuple(s.sums for s in tavg)
                        state, sums, diags = self._scan_tavg_fn(
                            state, sums, forcing, nsteps=self.scan_chunk)
                        for s, sm in zip(tavg, sums):
                            s.sums = sm
                            s.nsamples += self.scan_chunk
                    else:
                        state, diags = self._scan_leapfrog(
                            state, forcing, nsteps=self.scan_chunk)
                    self.nsteps_total += self.scan_chunk
                    for _ in range(self.scan_chunk):
                        self.time_manager.advance()
                    remaining -= self.scan_chunk
            else:
                state, diags = self.advance(state, forcing)
                remaining -= 1
            for s in tavg:
                if s.ready and s.nsamples > 0:
                    self.tavg_files.append(
                        s.write(self._tavg_outdir, self.nsteps_total))
                    s.reset()
        return state, diags

    # -- diagnostics (source/diagnostics.F90:1174-, check_KE :3260) ---------
    def diagnostics(self, state: State) -> Dict[str, float]:
        g = self.grid
        dz = jnp.reshape(g.vgrid.dz, (-1, 1, 1))
        uvol = jnp.sum(jnp.where(g.kmask_u, dz * g.UAREA, 0.0))
        ke = 0.5 * jnp.sum(jnp.where(
            g.kmask_u, dz * g.UAREA * (state.u_cur ** 2 + state.v_cur ** 2),
            0.0)) / uvol
        tvol = jnp.sum(jnp.where(g.kmask_t, dz * g.TAREA, 0.0))
        tmean = jnp.sum(jnp.where(g.kmask_t, dz * g.TAREA
                                  * state.tracer_cur[0], 0.0)) / tvol
        smean = jnp.sum(jnp.where(g.kmask_t, dz * g.TAREA
                                  * state.tracer_cur[1], 0.0)) / tvol
        return {
            "KE": float(ke),
            "TEMP_mean": float(tmean),
            "SALT_mean": float(smean) * const.SALT_TO_PPT,
            "SSH_rms_cm": float(jnp.sqrt(jnp.sum(
                (state.psurf_cur / const.GRAV) ** 2 * g.RCALCT)
                / jnp.sum(g.RCALCT))),
            "U_max": float(jnp.abs(state.u_cur).max()),
        }

    def check_ke(self, state: State, ke_limit: float = 100.0) -> None:
        """Blow-up guard (source/diagnostics.F90:3260; used in the run loop
        at drivers/mct/ocn_comp_mct.F90:~656)."""
        ke = self.diagnostics(state)["KE"]
        if not np.isfinite(ke) or ke > ke_limit:
            raise FloatingPointError(
                f"KE blow-up detected: KE={ke} exceeds {ke_limit} cm^2/s^2")
