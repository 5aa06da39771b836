#!/usr/bin/env python
"""Smoke run of the model on NVIDIA GPUs: the quickest proof that the system
still starts and steps correctly on the card.

    python chip_smoke.py            # one GPU: phases 1-4
    python chip_smoke.py --four     # four GPUs: the sharded path only

Phases (one process owns the card throughout):

1. device: a GPU must be JAX's first device (no CPU fallback); prints its
   kind, the device count, and the card's name and power limit.
2. Thomas kernel: the Pallas (Triton) tridiagonal kernel against the
   lax.scan sweep (``tridiag._thomas``) at gx1v7 widths (km=60, 384x320
   columns, the production KMT), float32 and float64, with timings.
3. main path: ``Model(get_production_config())`` in float32 — init, one
   Euler ``advance``, ``run_compiled`` over fused scan chunks; checks a
   finite state and reports u_max, solver iterations and residual, compile
   time, memory.
4. GPU against CPU: the production physics menu at mini dimensions, 5 steps
   on the GPU and on the host CPU in the same process, float64 and float32.

With ``--four``, only the sharded production run on meshes (4, 1) and
(2, 2) against a one-card run of the same steps.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Any failed check exits non-zero without it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# the host CPU backend is needed beside the GPU for phase 4
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ[
        "JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

FIELDS = ("T", "S", "u", "v", "psurf")


def require_gpu(devices):
    """Exit non-zero unless the first device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        sys.stderr.write(f"chip_smoke: no GPU found (first JAX device: "
                         f"{found}); nothing was run\n")
        raise SystemExit(2)


def log(msg):
    print(msg, flush=True)


def _median_ms(fn, args, reps):
    jax.block_until_ready(fn(*args))           # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def _fields(st):
    return {"T": st.tracer_cur[0], "S": st.tracer_cur[1], "u": st.u_cur,
            "v": st.v_cur, "psurf": st.psurf_cur}


def _compare(name, got, want, tol):
    """Max |got - want| over max |want| per field; True if all <= tol."""
    ok = True
    for f, rel in _rel(got, want).items():
        good = bool(np.isfinite(got[f]).all()) and rel <= tol
        ok &= good
        log(f"  {name} {f}: max|diff|/max|ref| = {rel!r} "
            f"(tol {tol:g}) {'ok' if good else 'FAIL'}")
    return ok


def phase_thomas(kmt, dz, dtt, reps=25):
    """Kernel vs scan at the grid's widths. Returns True if all agree."""
    from pop2_tpu import tridiag, tridiag_pallas
    km = dz.shape[0]
    ny, nx = kmt.shape
    # tolerances: identical per-column operation order, so only FMA
    # contraction and the division rounding differ; the sweep's error
    # growth over 60 levels is a few ulps of the largest |F|
    tols = {"float32": 1e-5, "float64": 1e-12}
    rng = np.random.RandomState(0)
    ok = True
    for dtype in ("float32", "float64"):
        dt = jnp.dtype(dtype)
        c2dtt = 2.0 * dtt
        hfac = jnp.asarray(dz / c2dtt, dt)
        kidx = np.arange(1, km + 1)[:, None, None]
        vdc = rng.uniform(0.0, 50.0, (km, ny, nx)) * (kidx < kmt[None])
        dzwr = np.concatenate([[2.0 / dz[0]], 2.0 / (dz[:-1] + dz[1:]),
                               [2.0 / dz[-1]]])
        a = tridiag._coupling(jnp.asarray(vdc, dt), jnp.asarray(dz, dt),
                              jnp.asarray(dzwr, dt), km, 1.0)
        h1 = hfac[0] + jnp.asarray(rng.randn(ny, nx) * 1e-3, dt)
        kmax = jnp.asarray(kmt, jnp.int32)
        for nr in ((1, 2, 4) if dtype == "float32" else (2,)):
            rhs = jnp.asarray(rng.randn(nr, km, ny, nx), dt)
            args = (hfac, h1, kmax, a, rhs)
            kern = tridiag_pallas.thomas_blocks

            @jax.jit
            def scan(hfac, h1, kmax, a, rhs):
                h3 = jnp.reshape(hfac, (-1, 1, 1))
                return jnp.stack(tridiag._thomas(h3, h1, a, kmax,
                                                 [h3 * r for r in rhs]))

            out = np.asarray(kern(*args), np.float64)
            ref = np.asarray(scan(*args), np.float64)
            rel = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
            good = bool(np.isfinite(out).all()) and rel <= tols[dtype]
            ok &= good
            t_k = _median_ms(kern, args, reps)
            t_s = _median_ms(scan, args, reps)
            log(f"  thomas {dtype} nr={nr} km={km} {ny}x{nx}: "
                f"max|diff|/max|ref| = {rel!r} (tol {tols[dtype]:g}) "
                f"{'ok' if good else 'FAIL'}; kernel {t_k!r} ms, "
                f"scan {t_s!r} ms (median of {reps})")
    return ok


def phase_main(cfg):
    """Production config in float32 through the user entry points."""
    from pop2_tpu import solvers
    from pop2_tpu.barotropic import diagonal_correction
    from pop2_tpu.model import Model

    log(f"  config: {cfg.nx}x{cfg.ny}x{cfg.km} {cfg.dtype}, vertical grid "
        f"'{cfg.vert_grid}' {cfg.vert_grid_file or ''}, overflows attached: "
        f"{[o.name for o in cfg.overflows] or 'none'}")
    t0 = time.perf_counter()
    model = Model(cfg)
    state = model.initial_state()
    jax.block_until_ready(state)
    active = [o.name for o in model.cfg.overflows] or "none"
    log(f"  init: {time.perf_counter() - t0!r} s; overflows active: "
        f"{active}")

    t0 = time.perf_counter()
    state, diags = model.advance(state)
    jax.block_until_ready(state)
    log(f"  Euler step (incl. compile): {time.perf_counter() - t0!r} s")

    n = model.scan_chunk
    t0 = time.perf_counter()
    compiled = model._scan_leapfrog.lower(state, model.forcing,
                                          nsteps=n).compile()
    log(f"  scan chunk ({n} steps) compile: {time.perf_counter() - t0!r} s")
    mem = compiled.memory_analysis()
    if mem is not None:
        log("  memory_analysis: " + ", ".join(
            f"{k}={getattr(mem, k)}" for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, k)))

    t0 = time.perf_counter()
    state, diags = model.run_compiled(state, n)
    jax.block_until_ready(state)
    log(f"  run_compiled({n}) first call: {time.perf_counter() - t0!r} s")
    t0 = time.perf_counter()
    state, diags = model.run_compiled(state, n)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    log(f"  run_compiled({n}) steady: {dt!r} s = {1e3 * dt / n!r} ms/step")

    finite = all(bool(jnp.isfinite(x).all())
                 for x in jax.tree_util.tree_leaves(state))
    u_max = float(jnp.max(jnp.abs(state.u_cur)))
    op = solvers.make_operator(model.grid,
                               diagonal_correction(cfg, model.grid, True))
    rms = float(np.sqrt(float(diags.solver_rr) * float(op.resid_norm)))
    crit = cfg.solver.convergence_criterion
    log(f"  state finite: {finite}; u_max = {u_max!r} cm/s")
    log(f"  solver: {int(diags.solver_iters)} iterations, final residual "
        f"(rms-normalized) {rms!r} vs criterion {crit:g}: "
        f"{'met' if rms < crit else 'NOT met'}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return finite and u_max < 1.0e3


def _run_steps(cfg, nsteps):
    """Fields and diagnostics after ``nsteps`` steps from the initial
    state."""
    from pop2_tpu.model import Model
    model = Model(cfg)
    st = model.initial_state()
    for _ in range(nsteps):
        st, diags = model.advance(st)
    return jax.device_get(_fields(st)), diags


def _rel(got, want):
    """Max |got - want| over max |want| for each field."""
    return {f: float(np.max(np.abs(np.asarray(got[f], np.float64)
                                   - np.asarray(want[f], np.float64)))
                     / max(float(np.max(np.abs(want[f]))), 1e-300))
            for f in FIELDS}


def phase_gpu_vs_cpu(nsteps=5):
    """The production menu at mini dims on the GPU and on the host CPU.

    float64: GPU vs CPU within 1e-9 of each field's max. The two programs
    differ in reduction order and FMA contraction only, but psurf, u and v
    come out of near-cancelling terms (geostrophic balance in the vertical
    mean forcing), which amplify the last-bit differences by about 1e5.

    float32: the same amplification turns float32 rounding into percent
    differences in psurf, so the check is on accuracy instead: each
    device's float32 result against the CPU's float64 result, where the
    GPU's error may exceed the CPU's by at most 10x (plus 1e-6 of the
    field's max). Reduced-precision contractions (TF32) or a broken
    compensated solve would show as a GPU error far above the CPU's.
    """
    from pop2_tpu.production import get_production_menu_mini
    cpu = jax.devices("cpu")[0]
    runs = {}
    for dtype in ("float64", "float32"):
        cfg = get_production_menu_mini(dtype=dtype, tol=1e-13)
        runs["gpu", dtype] = _run_steps(cfg, nsteps)
        with jax.default_device(cpu):
            runs["cpu", dtype] = _run_steps(cfg, nsteps)
    for (dev, dtype), (_, diags) in sorted(runs.items()):
        log(f"  {dev} {dtype}: solver {int(diags.solver_iters)} iterations,"
            f" rr {float(diags.solver_rr)!r}")
    ok = _compare("gpu-vs-cpu float64", runs["gpu", "float64"][0],
                  runs["cpu", "float64"][0], 1e-9)
    ref = runs["cpu", "float64"][0]
    err_gpu = _rel(runs["gpu", "float32"][0], ref)
    err_cpu = _rel(runs["cpu", "float32"][0], ref)
    direct = _rel(runs["gpu", "float32"][0], runs["cpu", "float32"][0])
    for f in FIELDS:
        good = err_gpu[f] <= 10.0 * err_cpu[f] + 1e-6
        ok &= good
        log(f"  float32 {f}: error vs cpu float64: gpu {err_gpu[f]!r}, "
            f"cpu {err_cpu[f]!r} (gpu <= 10x cpu + 1e-6) "
            f"{'ok' if good else 'FAIL'}; gpu-vs-cpu {direct[f]!r}")
    return ok


def phase_four(cfg, nsteps=1):
    """Sharded production run on 4 GPUs vs one card, same steps. One
    (Euler) step runs the whole step program — KPP, GM, advection, the
    per-shard Thomas kernel, the barotropic solve's global reductions and
    the tripole fold across x shards — at one compile per mesh."""
    from pop2_tpu.parallel import mesh as pmesh
    # tolerance: the meshes sum their global reductions in another order
    # and compile their fusions separately, so they differ from one card
    # in the last bits, and psurf, u and v amplify such differences by
    # orders of magnitude (see phase_gpu_vs_cpu). So the check is on
    # accuracy against a one-card float64 run of the same step: a mesh's
    # float32 error may exceed the one-card float32 error by at most 10x
    # (plus 1e-6 of the field's max).
    t0 = time.perf_counter()
    want, _ = _run_steps(cfg, nsteps)
    log(f"  one card, {nsteps} step(s): {time.perf_counter() - t0!r} s")
    got = {}
    for shape in ((4, 1), (2, 2)):
        t0 = time.perf_counter()
        model, mesh = pmesh.sharded_model(cfg.with_(mesh_shape=shape))
        st = pmesh.shard_pytree(model.initial_state(), mesh)
        for _ in range(nsteps):
            st, _ = model.advance(st)
        got[shape] = jax.device_get(_fields(st))
        del model, st
        log(f"  mesh {shape}, {nsteps} step(s): "
            f"{time.perf_counter() - t0!r} s; max|diff|/max|ref| vs one "
            f"card: {_rel(got[shape], want)}")
    t0 = time.perf_counter()
    ref, _ = _run_steps(cfg.with_(dtype="float64"), nsteps)
    err_one = _rel(want, ref)
    log(f"  one card float64, {nsteps} step(s): "
        f"{time.perf_counter() - t0!r} s")
    ok = True
    for shape, g in got.items():
        err = _rel(g, ref)
        for f in FIELDS:
            good = (bool(np.isfinite(g[f]).all())
                    and err[f] <= 10.0 * err_one[f] + 1e-6)
            ok &= good
            log(f"  mesh {shape} {f}: error vs one-card float64: mesh "
                f"{err[f]!r}, one card {err_one[f]!r} (mesh <= 10x one "
                f"card + 1e-6) {'ok' if good else 'FAIL'}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded comparison")
    args = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    from pop2_tpu import compile_cache
    from pop2_tpu.production import get_production_config

    log(f"compile cache: {compile_cache.enable()}")
    dev = devices[0]
    log(f"device: {dev.device_kind}, count {len(devices)}, jax "
        f"{jax.__version__}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    log("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())

    results = {}
    cfg = get_production_config(dtype="float32")
    if args.four:
        if len(devices) < 4:
            sys.stderr.write(f"--four needs 4 GPUs, found {len(devices)}\n")
            raise SystemExit(2)
        log("phase four: prod_full float32 sharded vs one card")
        results["four"] = phase_four(cfg)
    else:
        from pop2_tpu.grid import build_grid
        log("phase thomas: kernel vs scan at gx1v7 widths")
        grid = build_grid(cfg)
        results["thomas"] = phase_thomas(
            np.asarray(grid.KMT), np.asarray(grid.vgrid.dz, np.float64),
            cfg.time.dtt)
        del grid
        log("phase main: prod_full float32")
        results["main"] = phase_main(cfg)
        log("phase gpu-vs-cpu: production menu at mini dims")
        results["gpu_vs_cpu"] = phase_gpu_vs_cpu()

    log(f"phases: {results}")
    if not all(results.values()):
        sys.stderr.write("chip_smoke: a phase failed\n")
        raise SystemExit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main()
