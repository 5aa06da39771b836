"""Barotropic elliptic solvers: ChronGear, PCSI, and standard PCG.

Reference: ``source/POP_SolversMod.F90`` — ChronGear (:1841, one fused 2-field
reduction per iteration), PCSI (:1510, Stiefel iteration with NO per-iteration
reduction — eigenvalue bounds from a Lanczos pass at init, :2699), PCG (:1200),
and the 9-point operator (:2376) exploiting weight symmetry.

The whole iteration runs inside one ``lax.while_loop`` under jit.
There are no explicit halo updates — the shift ops imply them, and XLA
schedules the collectives when the arrays are sharded. The reference's
clinic<->tropic block redistribution (source/POP_SolversMod.F90:327-500) is
dropped entirely: on a device mesh the 2-D solve lives on the same mesh as the
3-D state (SURVEY.md §2.2 strategy 2 rationale).

The reference checks convergence every ``convergenceCheckFreq`` iterations to
amortize the reduction; we keep the same policy — between checks the loop body
has zero global collectives for PCSI and exactly one fused psum for ChronGear.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pop2_tpu.config import ModelConfig
from pop2_tpu.grid import Grid
from pop2_tpu.stencil import BC


class BtropOperator(NamedTuple):
    """9-point operator weights on T points. ``center`` includes the
    time-dependent free-surface diagonal term (POP_SolversPrep,
    source/POP_SolversMod.F90:181-270)."""
    center: jnp.ndarray
    north: jnp.ndarray
    east: jnp.ndarray
    ne: jnp.ndarray
    mask: jnp.ndarray    # RCALCT (1/0) — reductions masked to ocean points
    resid_norm: jnp.ndarray  # 1/sum(TAREA^2 over ocean): rms normalization


def make_operator(grid: Grid, diagonal_correction) -> BtropOperator:
    """center = centerWgtClinicIndep - diagonalCorrection
    (source/POP_SolversMod.F90:249-253)."""
    return BtropOperator(
        center=grid.btrop_c_indep - diagonal_correction,
        north=grid.btrop_n, east=grid.btrop_e, ne=grid.btrop_ne,
        mask=grid.RCALCT, resid_norm=grid.residual_norm)


class FullOp9(NamedTuple):
    """A 9-point operator with INDEPENDENT weights per direction. The
    compressed BtropOperator form forces the quartet equality
    A[p,p+SE] == A[p+S,p+E] (both couplings read the same stored NE
    value — true for the div-grad discretization, whose cross-diagonal
    couplings share the corner weight, source/POP_SolversMod.F90:2412),
    which a diagonal similarity scaling breaks; the scaled inner system
    of solve_refined therefore carries this general form."""
    center: jnp.ndarray
    north: jnp.ndarray
    south: jnp.ndarray
    east: jnp.ndarray
    west: jnp.ndarray
    ne: jnp.ndarray
    nw: jnp.ndarray
    se: jnp.ndarray
    sw: jnp.ndarray
    mask: jnp.ndarray
    resid_norm: jnp.ndarray


def apply_op(op, x, bc: BC):
    """A @ x via the 9-point stencil (source/POP_SolversMod.F90:2412-2426);
    for the compressed form the S/W/SW weights are shifted copies of
    N/E/NE."""
    if isinstance(op, FullOp9):
        return (op.center * x
                + op.north * bc.n(x) + op.south * bc.s(x)
                + op.east * bc.e(x) + op.west * bc.w(x)
                + op.ne * bc.ne(x) + op.se * bc.se(x)
                + op.nw * bc.nw(x) + op.sw * bc.sw(x))
    return (op.center * x
            + op.north * bc.n(x) + bc.s(op.north) * bc.s(x)
            + op.east * bc.e(x) + bc.w(op.east) * bc.w(x)
            + op.ne * bc.ne(x) + bc.s(op.ne) * bc.se(x)
            + bc.w(op.ne) * bc.nw(x) + bc.sw(op.ne) * bc.sw(x))


def _masked_sum(x, mask, b4b: bool = False):
    """Masked global dot-product sum (POP_GlobalSum,
    mpi/POP_ReductionsMod.F90). ``b4b`` selects the decomposition-independent
    reproducible path (reductions.global_sum; the reference's b4b_flag,
    mpi/global_reductions.F90:134,599)."""
    from pop2_tpu.reductions import global_sum
    return global_sum(x * mask, b4b=b4b)


def _diag_precond(op: BtropOperator):
    return jnp.where(op.center != 0.0, 1.0 / jnp.where(op.center != 0.0,
                                                       op.center, 1.0), 0.0)


class Precond9(NamedTuple):
    """Precomputed 9-point preconditioner stencil M^-1 ~ A^-1 (the
    reference's 'file' preconditioner, source/POP_SolversMod.F90:2310-2324;
    coefficients read from a preconditioner file at init :700-760). The
    reference's EVP alternative (:2326-2364, per-8x8-sub-block error-vector
    propagation) exists to cut iteration counts on latency-bound MPI
    machines; its counterpart here is PCSI's reduction-free loop, so
    EVP itself is not rebuilt."""
    center: jnp.ndarray
    north: jnp.ndarray
    south: jnp.ndarray
    east: jnp.ndarray
    west: jnp.ndarray
    ne: jnp.ndarray
    nw: jnp.ndarray
    se: jnp.ndarray
    sw: jnp.ndarray


def load_precond(path: str, dtype) -> Precond9:
    """Load a 9-point preconditioner from an .npz with the field names of
    Precond9 (the npz counterpart of the reference's binary
    preconditioner file)."""
    import numpy as np_
    data = np_.load(path)
    return Precond9(**{k: jnp.asarray(data[k], dtype)
                       for k in Precond9._fields})


def make_precond_apply(cfg: ModelConfig, op: BtropOperator, bc: BC,
                       precond: Optional["Precond9"] = None):
    """Returns z = M^-1 r as a closure: diagonal (default) or the 9-point
    file stencil (preconditioner dispatch,
    source/POP_SolversMod.F90:2273-2364)."""
    choice = cfg.solver.preconditioner.lower()
    if choice == "diagonal" or precond is None:
        a0r = _diag_precond(op)
        return lambda r: r * a0r
    if isinstance(precond, FSPAI9):
        return fspai_apply(precond, bc)
    if choice in ("file", "spai"):
        p = precond

        def apply9(r):
            return (p.center * r
                    + p.north * bc.n(r) + p.south * bc.s(r)
                    + p.east * bc.e(r) + p.west * bc.w(r)
                    + p.ne * bc.ne(r) + p.nw * bc.nw(r)
                    + p.se * bc.se(r) + p.sw * bc.sw(r))
        return apply9
    raise NotImplementedError(f"preconditioner {cfg.solver.preconditioner}")


def chron_gear(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
               precond: Optional[Precond9] = None,
               tol=None, max_iter=None, stop_on_stall: bool = False):
    """Chronopoulos-Gear preconditioned CG
    (source/POP_SolversMod.F90:1841-2266). Returns (x, iterations, rr).
    ``tol``/``max_iter`` override the config values (traced values are
    fine — used by the iterative-refinement outer loop).

    ``stop_on_stall`` exits when a convergence check improves rr by less
    than 10%: an fp32 inner solve that has hit its precision floor stops
    burning iterations and returns its partial solution (the refinement
    outer loop recovers the remaining digits on the next sweep)."""
    sol = cfg.solver
    minv = make_precond_apply(cfg, op, bc, precond)
    if tol is None:
        tol = (jnp.asarray(sol.convergence_criterion, x0.dtype) ** 2
               / op.resid_norm)  # source/POP_SolversMod.F90:906
    if max_iter is None:
        max_iter = sol.max_iterations
    ncheck = sol.convergence_check_freq

    # initial residual + one pass of the standard algorithm; divisions are
    # guarded so an already-converged (e.g. zero-RHS) system stays finite
    r = b - apply_op(op, x0, bc)
    rr_init = _masked_sum(r * r, op.mask, cfg.b4b)
    z = minv(r)
    s = z
    q = apply_op(op, s, bc)
    sums = jnp.stack([_masked_sum(r * z, op.mask, cfg.b4b),
                      _masked_sum(s * q, op.mask, cfg.b4b)])
    rho_old, sigma = sums[0], sums[1]
    alpha = rho_old / jnp.where(sigma != 0.0, sigma, 1.0)
    x = x0 + alpha * s
    r = r - alpha * q

    def cond(carry):
        x, r, s, q, rho_old, sigma, rr, m, done = carry
        return (~done) & (m < max_iter)

    def body(carry):
        x, r, s, q, rho_old, sigma, rr, m, done = carry
        z = minv(r)
        az = apply_op(op, z, bc)
        sums = jnp.stack([_masked_sum(r * z, op.mask, cfg.b4b),
                          _masked_sum(az * z, op.mask, cfg.b4b)])
        rho, delta = sums[0], sums[1]
        beta = rho / jnp.where(rho_old != 0.0, rho_old, 1.0)
        sigma_new = delta - beta ** 2 * sigma
        alpha = rho / jnp.where(sigma_new != 0.0, sigma_new, 1.0)
        s_new = z + beta * s
        q_new = az + beta * q
        x_new = x + alpha * s_new
        r_new = r - alpha * q_new

        def check(args):
            x_new, r_new = args
            r_true = b - apply_op(op, x_new, bc)
            rr = _masked_sum(r_true * r_true, op.mask, cfg.b4b)
            return r_true, rr

        do_check = (m + 1) % ncheck == 0
        r_new, rr_new = jax.lax.cond(
            do_check, check, lambda a: (a[1], rr), (x_new, r_new))
        done_new = do_check & (rr_new < tol)
        if stop_on_stall:
            done_new = done_new | (do_check & (rr_new > 0.9 * rr))
        return (x_new, r_new, s_new, q_new, rho, sigma_new, rr_new,
                m + 1, done_new)

    rr0 = jnp.where(rr_init < tol, rr_init,
                    jnp.asarray(jnp.inf, x0.dtype))
    carry = (x, r, s, q, rho_old, sigma, rr0,
             jnp.asarray(0, jnp.int32), rr_init < tol)
    x, r, s, q, rho_old, sigma, rr, m, done = jax.lax.while_loop(
        cond, body, carry)
    return x, m, rr


def pcsi(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
         eig_min, eig_max, precond: Optional[Precond9] = None,
         tol=None, max_iter=None, stop_on_stall: bool = False):
    """Preconditioned Classical Stiefel Iteration
    (source/POP_SolversMod.F90:1510-1835; Hu et al. 2013): no reductions in
    the steady-state loop body — the latency-friendly choice for large
    meshes. eig_min/eig_max bound the preconditioned operator's spectrum."""
    sol = cfg.solver
    minv = make_precond_apply(cfg, op, bc, precond)
    if tol is None:
        tol = (jnp.asarray(sol.convergence_criterion, x0.dtype) ** 2
               / op.resid_norm)  # source/POP_SolversMod.F90:906
    if max_iter is None:
        max_iter = sol.max_iterations
    ncheck = sol.convergence_check_freq
    nstart = sol.convergence_check_start

    csalpha = 2.0 / (eig_max - eig_min)
    csbeta = (eig_max + eig_min) / (eig_max - eig_min)
    csy = csbeta / csalpha
    omga0 = 2.0 / csy

    r = b - apply_op(op, x0, bc)
    q = (1.0 / csy) * minv(r)
    x = x0 + q
    r = b - apply_op(op, x, bc)

    def cond(carry):
        x, r, q, omga, rr, m, done = carry
        return (~done) & (m < max_iter)

    def body(carry):
        x, r, q, omga, rr, m, done = carry
        omga_new = 1.0 / (csy - omga / (4.0 * csalpha * csalpha))
        rp = minv(r)
        q_new = omga_new * rp + (csy * omga_new - 1.0) * q
        x_new = x + q_new
        r_new = b - apply_op(op, x_new, bc)

        do_check = ((m + 1) % ncheck == 0) & (m + 1 >= nstart)
        rr_new = jax.lax.cond(
            do_check,
            lambda rn: _masked_sum(rn * rn, op.mask, cfg.b4b),
            lambda rn: rr, r_new)
        done_new = do_check & (rr_new < tol)
        if stop_on_stall:
            done_new = done_new | (do_check & (rr_new > 0.9 * rr))
        return (x_new, r_new, q_new, omga_new, rr_new, m + 1, done_new)

    rr0 = jnp.asarray(jnp.inf, x0.dtype)
    carry = (x, r, q, jnp.asarray(omga0, x0.dtype), rr0,
             jnp.asarray(0, jnp.int32), jnp.asarray(False))
    x, r, q, omga, rr, m, done = jax.lax.while_loop(cond, body, carry)
    return x, m, rr


def pcg(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
        precond: Optional[Precond9] = None, tol=None, max_iter=None,
        stop_on_stall: bool = False):
    """Standard preconditioned CG (source/POP_SolversMod.F90:1200-1508)."""
    sol = cfg.solver
    minv = make_precond_apply(cfg, op, bc, precond)
    if tol is None:
        tol = (jnp.asarray(sol.convergence_criterion, x0.dtype) ** 2
               / op.resid_norm)  # source/POP_SolversMod.F90:906
    if max_iter is None:
        max_iter = sol.max_iterations
    ncheck = sol.convergence_check_freq

    r = b - apply_op(op, x0, bc)
    s = jnp.zeros_like(x0)

    def cond(carry):
        x, r, s, eta_old, rr, m, done = carry
        return (~done) & (m < max_iter)

    def body(carry):
        x, r, s, eta_old, rr, m, done = carry
        z = minv(r)
        eta = _masked_sum(r * z, op.mask, cfg.b4b)
        s_new = z + s * (eta / jnp.where(eta_old != 0.0, eta_old, 1.0))
        q = apply_op(op, s_new, bc)
        sq = _masked_sum(s_new * q, op.mask, cfg.b4b)
        alpha = eta / jnp.where(sq != 0.0, sq, 1.0)
        x_new = x + alpha * s_new
        r_new = r - alpha * q

        do_check = (m + 1) % ncheck == 0

        def check(args):
            x_new, r_new = args
            r_true = b - apply_op(op, x_new, bc)
            return r_true, _masked_sum(r_true * r_true, op.mask, cfg.b4b)

        r_new, rr_new = jax.lax.cond(do_check, check, lambda a: (a[1], rr),
                                     (x_new, r_new))
        done_new = do_check & (rr_new < tol)
        if stop_on_stall:
            done_new = done_new | (do_check & (rr_new > 0.9 * rr))
        return (x_new, r_new, s_new, eta, rr_new, m + 1, done_new)

    eta0 = jnp.asarray(1.0, x0.dtype)
    rr0 = jnp.asarray(jnp.inf, x0.dtype)
    carry = (x0, r, s, eta0, rr0, jnp.asarray(0, jnp.int32),
             jnp.asarray(False))
    x, r, s, eta_old, rr, m, done = jax.lax.while_loop(cond, body, carry)
    return x, m, rr


# ---- compensated (double-single) arithmetic for iterative refinement ----
# The production convergence criterion (1e-13 rms,
# namelist_defaults_pop.xml convergenceCriterion) sits below the fp32
# residual floor. Instead of emulating f64 end to end,
# the solve runs fp32 PCSI/ChronGear inner iterations wrapped in classic
# mixed-precision iterative refinement: the solution accumulates in a
# double-single (hi, lo) pair and the outer residual is computed with
# error-free transformations (Dekker/Knuth), giving an effective ~2^-48
# relative residual floor at fp32 speed.

def _two_sum(a, b):
    """Knuth branch-free TwoSum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _two_prod(a, b):
    """Dekker TwoProd (float32 split at 12 bits): p + err == a*b exactly."""
    p = a * b
    c = a * jnp.asarray(4097.0, a.dtype)       # 2^12 + 1
    ah = c - (c - a)
    al = a - ah
    c = b * jnp.asarray(4097.0, b.dtype)
    bh = c - (c - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _dd_apply(op: BtropOperator, bc: BC, xh, xl):
    """A @ (xh + xl) with a compensated hi/lo accumulator: the 9 stencil
    products of xh go through TwoProd/TwoSum; the lo part xl (already
    ~2^-24 of xh) multiplies in working precision."""
    pairs = (
        (op.center, lambda z: z),
        (op.north, bc.n), (bc.s(op.north), bc.s),
        (op.east, bc.e), (bc.w(op.east), bc.w),
        (op.ne, bc.ne), (bc.s(op.ne), bc.se),
        (bc.w(op.ne), bc.nw), (bc.sw(op.ne), bc.sw),
    )
    sh = jnp.zeros_like(xh)
    sl = jnp.zeros_like(xh)
    for c, shift in pairs:
        p, pe = _two_prod(c, shift(xh))
        sh, e = _two_sum(sh, p)
        sl = sl + (e + pe + c * shift(xl))
    return _two_sum(sh, sl)


def _dd_residual(op: BtropOperator, bc: BC, b, xh, xl):
    """r = b - A(xh+xl), compensated; returns the (hi, lo) residual pair."""
    ah, al = _dd_apply(op, bc, xh, xl)
    rh, e = _two_sum(b, -ah)
    return _two_sum(rh, e - al)


def _scale_op(op: BtropOperator, s, bc: BC) -> FullOp9:
    """Symmetrically scaled operator A~[p,q] = s[p] A[p,q] s[q], expanded
    to independent per-direction weights (FullOp9): the compressed form's
    derived couplings pair the WRONG s values for the cross-diagonal
    directions once scaling breaks the quartet equality."""
    return FullOp9(
        center=op.center * s * s,
        north=op.north * s * bc.n(s),
        south=bc.s(op.north) * s * bc.s(s),
        east=op.east * s * bc.e(s),
        west=bc.w(op.east) * s * bc.w(s),
        ne=op.ne * s * bc.ne(s),
        se=bc.s(op.ne) * s * bc.se(s),
        nw=bc.w(op.ne) * s * bc.nw(s),
        sw=bc.sw(op.ne) * s * bc.sw(s),
        mask=op.mask, resid_norm=op.resid_norm)


def _scale_precond(p: Precond9, si, bc: BC) -> Precond9:
    """M~ = S^-1 M S^-1 for the scaled system (M approximates A^-1)."""
    return Precond9(
        center=p.center * si * si,
        north=p.north * si * bc.n(si), south=p.south * si * bc.s(si),
        east=p.east * si * bc.e(si), west=p.west * si * bc.w(si),
        ne=p.ne * si * bc.ne(si), nw=p.nw * si * bc.nw(si),
        se=p.se * si * bc.se(si), sw=p.sw * si * bc.sw(si))


def solve_refined(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
                  eigs: Tuple[float, float] = None,
                  precond: Optional[Precond9] = None,
                  n_outer: int = 6):
    """Mixed-precision iterative refinement: fp32 inner solves (the
    configured solver choice) + double-single residual/accumulator. Meets
    the reference's f64-grade convergence criterion
    (convergenceCriterion**2/residualNorm, source/POP_SolversMod.F90:906)
    from fp32 inner solves. Returns (x, total_iterations, rr) with rr
    the compensated true-residual norm.

    The inner solves run on the symmetrically diagonal-scaled system
    A~ = S A S, S = diag(|diag A|^-1/2): the fp32 noise committed inside
    an inner iteration scales with the RAW operator's condition number
    (TAREA^2 spans orders of magnitude across a real grid), and unscaled
    it floors the refinement near 1e-10 rms regardless of sweeps — scaled,
    each sweep robustly gains ~4 digits (measured on gx1v7)."""
    sol = cfg.solver
    f = x0.dtype
    tol = (jnp.asarray(sol.convergence_criterion, f) ** 2
           / op.resid_norm.astype(f))

    d = jnp.abs(op.center)
    land = d == 0.0
    s = jnp.where(land, 0.0, 1.0 / jnp.sqrt(jnp.where(land, 1.0, d)))
    si = jnp.where(land, 0.0, jnp.sqrt(d))
    op_s = _scale_op(op, s, bc)
    if precond is None:
        pre_s = None
    elif isinstance(precond, FSPAI9):
        pre_s = scale_fspai(precond, si, bc)
    else:
        pre_s = _scale_precond(precond, si, bc)

    def inner(rhs, tol_i, max_i):
        z = jnp.zeros_like(x0)
        choice = sol.choice.lower()
        if sol.refine_inner == "chrongear":
            # CG inner regardless of the outer 'choice': needs no spectrum
            # bounds, and fp32 Lanczos Ritz values OVERestimate eig_min,
            # which stalls a Stiefel inner on the modes below the bound
            # (observed: 6x1000 burned iterations on gx1v7)
            choice = "chrongear"
        if choice == "pcsi":
            # eigenvalue bounds are of the diagonally-preconditioned
            # operator, which the scaling reproduces (same similarity class)
            return pcsi(cfg, op_s, bc, z, rhs, eigs[0], eigs[1], pre_s,
                        tol=tol_i, max_iter=max_i, stop_on_stall=True)
        if choice == "chrongear":
            return chron_gear(cfg, op_s, bc, z, rhs, pre_s,
                              tol=tol_i, max_iter=max_i, stop_on_stall=True)
        return pcg(cfg, op_s, bc, z, rhs, pre_s, tol=tol_i, max_iter=max_i,
                   stop_on_stall=True)

    # each inner solve reduces the (squared) residual of its own RHS by
    # 1e-9 in rr terms (~4.5 digits in residual) — achievable on the
    # scaled system; the stall exit returns whatever an early plateau
    # allows and the next sweep recovers the remainder
    inner_reduce = jnp.asarray(1e-9, f)

    def cond(carry):
        xh, xl, m_tot, rr, k, done = carry
        return (~done) & (k < n_outer)

    def body(carry):
        xh, xl, m_tot, rr, k, done = carry
        rh, rl = _dd_residual(op, bc, b, xh, xl)
        rr_new = _masked_sum(rh * rh, op.mask, cfg.b4b)
        done_new = rr_new < tol
        # converged: zero the inner iteration budget so the inner
        # while_loop exits immediately
        max_i = jnp.where(done_new, 0, sol.max_iterations)
        rhs_s = s * rh
        rr_s = _masked_sum(rhs_s * rhs_s, op.mask, cfg.b4b)
        tol_i = rr_s * inner_reduce
        dy, m, _ = inner(rhs_s, tol_i, max_i)
        dx = s * dy
        sh, e = _two_sum(xh, jnp.where(done_new, 0.0, dx))
        xh2, xl2 = _two_sum(sh, xl + e)
        return (xh2, xl2, m_tot + m, rr_new, k + 1, done_new)

    carry = (x0, jnp.zeros_like(x0), jnp.asarray(0, jnp.int32),
             jnp.asarray(jnp.inf, f), jnp.asarray(0, jnp.int32),
             jnp.asarray(False))
    xh, xl, m_tot, rr, k, done = jax.lax.while_loop(cond, body, carry)
    # final compensated residual for faithful reporting
    rh, _ = _dd_residual(op, bc, b, xh, xl)
    rr_fin = _masked_sum(rh * rh, op.mask, cfg.b4b)
    return xh + xl, m_tot, rr_fin


def lanczos_eigs(cfg: ModelConfig, op: BtropOperator, bc: BC,
                 n_iter: int = None, seed: int = 0) -> Tuple[float, float]:
    """Estimate extreme eigenvalues of the diagonally-preconditioned operator
    by a Lanczos pass (PcsiLanczos, source/POP_SolversMod.F90:2699-3120; the
    reference then solves the tridiagonal eigenproblem with ratqr :3122 —
    here numpy does it on the host at init time).

    Returns (eig_min, eig_max) scaled with the reference's safety margins.
    """
    if n_iter is None:
        n_iter = cfg.solver.lanczos_iterations
    mask = np.asarray(op.mask)

    # Lanczos needs a symmetric operator: use the symmetrized
    # D^{-1/2} (-A) D^{-1/2} with D = |diag(A)|, which is similar to the
    # diagonally-preconditioned M^{-1}A used by the PCSI recurrence and
    # therefore shares its (positive) spectrum.
    d = jnp.abs(op.center)
    dmh = jnp.where(d > 0.0, 1.0 / jnp.sqrt(jnp.where(d > 0.0, d, 1.0)), 0.0)
    apply_j = jax.jit(lambda v: -dmh * apply_op(op, dmh * v, bc))

    rng = np.random.RandomState(seed)
    v0 = rng.rand(*mask.shape) * mask
    v0 /= np.sqrt((v0 * v0).sum())
    mask_j = jnp.asarray(mask, v0.dtype)

    # the whole recurrence runs on-device as ONE lax.scan (one compile,
    # one transfer), not one host round trip per iteration
    @jax.jit
    def lanczos(v):
        def body(carry, _):
            v, v_prev, beta = carry
            w = apply_j(v) * mask_j
            alpha = jnp.sum(w * v)
            w = w - alpha * v - beta * v_prev
            beta_new = jnp.sqrt(jnp.sum(w * w))
            safe = jnp.where(beta_new < 1e-30, 1.0, beta_new)
            v_next = jnp.where(beta_new < 1e-30, v, w / safe)
            return (v_next, v, beta_new), (alpha, beta_new)

        _, (al, be) = jax.lax.scan(
            body, (v, jnp.zeros_like(v), jnp.asarray(0.0, v.dtype)),
            None, length=n_iter)
        return al, be

    al, be = lanczos(jnp.asarray(v0))
    alphas = np.asarray(al)
    betas = np.asarray(be)
    # truncate at breakdown (beta ~ 0), as the host loop did
    stop = np.nonzero(betas < 1e-30)[0]
    if stop.size:
        ncut = int(stop[0]) + 1
        alphas, betas = alphas[:ncut], betas[:ncut]
    T = np.diag(alphas) + np.diag(betas[:-1], 1) + np.diag(betas[:-1], -1)
    eigs = np.linalg.eigvalsh(T)
    # preconditioned operator is negative definite (center<0 diag precond
    # makes it ~ +1 on the diagonal); use |eigs| bounds with margins like the
    # reference (PcsiLanczos scales nu by 1/1.05 and mu by 1.05 empirically)
    emin = float(np.min(np.abs(eigs))) / 1.05
    emax = float(np.max(np.abs(eigs))) * 1.05
    return emin, emax


def solve(cfg: ModelConfig, op: BtropOperator, bc: BC, x0, b,
          eigs: Tuple[float, float] = None,
          precond: Optional[Precond9] = None):
    """Dispatch on cfg.solver.choice (source/POP_SolversMod.F90:327-500)."""
    choice = cfg.solver.choice.lower()
    if choice == "chrongear":
        return chron_gear(cfg, op, bc, x0, b, precond)
    if choice == "pcsi":
        if eigs is None:
            raise ValueError("PCSI requires Lanczos eigenvalue bounds")
        return pcsi(cfg, op, bc, x0, b, eigs[0], eigs[1], precond)
    if choice == "pcg":
        return pcg(cfg, op, bc, x0, b, precond)
    raise NotImplementedError(choice)


# ---- sparse-approximate-inverse preconditioner (generated at init) ----
# The reference reads its 9-pt preconditioner stencil from a file
# (source/POP_SolversMod.F90:700-760, applied :2310-2324) whose generator
# lives outside the repo. This build generates the coefficients at
# init: a Frobenius-norm SPAI — per ocean point, the 9-point row m_p
# minimizing ||A m_p - e_p||_2 — assembled batched on the host (one
# sparse-squared stencil + 122k simultaneous 9x9 solves for gx1), then
# symmetrized so CG/PCSI theory applies. Cuts the diagonally-
# preconditioned condition number by roughly an order of magnitude,
# which is the main lever on the 1e-13 production solve cost.

_OFFS9 = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
          (1, 1), (1, -1), (-1, 1), (-1, -1))
_FIELD_OF_OFF = {(0, 0): "center", (1, 0): "north", (-1, 0): "south",
                 (0, 1): "east", (0, -1): "west", (1, 1): "ne",
                 (1, -1): "nw", (-1, 1): "se", (-1, -1): "sw"}


def _row_stencils(op: BtropOperator, sh):
    """Dense per-point row weights W1[(dj,di)] of the 9-pt operator
    (apply_op's coefficient layout: S/W/SW weights are shifted N/E/NE)."""
    c = np.asarray(op.center, np.float64)
    n_ = np.asarray(op.north, np.float64)
    e_ = np.asarray(op.east, np.float64)
    ne_ = np.asarray(op.ne, np.float64)
    return {
        (0, 0): c,
        (1, 0): n_, (-1, 0): sh(n_, 0, -1),
        (0, 1): e_, (0, -1): sh(e_, -1, 0),
        (1, 1): ne_, (-1, 1): sh(ne_, 0, -1),
        (1, -1): sh(ne_, -1, 0), (-1, -1): sh(ne_, -1, -1),
    }


def build_spai9(cfg: ModelConfig, op: BtropOperator, ridge: float = 1e-10
                ) -> Precond9:
    """Build the symmetric 9-point SPAI stencil M ~ A^-1 on the host.

    G_p[a,b] = (A^2)[p+o_a, p+o_b] (A symmetric), so the normal-equation
    Gram matrices come from the 25-point stencil of A^2 — assembled as
    shifted products of the row stencils, no sparse matrices needed. The
    tripole seam is treated as closed for the BUILD only (any SPD M is a
    valid preconditioner; the solve itself keeps the exact fold via bc).
    """
    from pop2_tpu.grid import _np_shift
    ew = cfg.ew_boundary
    ny, nx = op.center.shape

    def sh(f, di, dj):
        return _np_shift(f, di, dj, ew, "closed", 0.0, "center", "scalar")

    w1 = _row_stencils(op, sh)
    mask = np.asarray(op.mask, np.float64) * (w1[(0, 0)] != 0.0)

    # A^2 stencil: W2[o2][p] = sum_o W1[o][p] * W1[o2-o][p+o]
    w2 = {}
    for (dj, di), wa in w1.items():
        for (dj2, di2), _ in w1.items():
            o2 = (dj + dj2, di + di2)
            contrib = wa * sh(w1[(dj2, di2)], di, dj)
            w2[o2] = w2.get(o2, 0.0) + contrib

    P = ny * nx
    G = np.zeros((P, 9, 9))
    b = np.zeros((P, 9))
    valid = np.zeros((P, 9), bool)
    for a, (dja, dia) in enumerate(_OFFS9):
        ok_a = sh(mask, dia, dja) > 0      # support point p+o_a is ocean
        valid[:, a] = ok_a.ravel()
        b[:, a] = w1[(dja, dia)].ravel()
        for bb, (djb, dib) in enumerate(_OFFS9):
            o = (djb - dja, dib - dia)
            if o in w2:
                # (A^2)[p+o_a, p+o_b] = W2[o_b-o_a] evaluated at p+o_a
                G[:, a, bb] = sh(w2[o], dia, dja).ravel()

    # deactivate invalid support points; regularize
    act = valid[:, :, None] & valid[:, None, :]
    G = np.where(act, G, 0.0)
    diag_scale = np.maximum(np.abs(G[:, 0, 0]), 1.0)
    eye = np.eye(9)[None]
    G = G + (ridge * diag_scale[:, None, None] + 1e-300) * eye
    G[~valid[:, 0]] = eye                  # land rows: trivial system
    b = np.where(valid, b, 0.0)

    m = np.linalg.solve(G, b[..., None])[..., 0]     # (P, 9)
    m = np.where(valid, m, 0.0)
    m[~valid[:, 0]] = 0.0

    fields = {_FIELD_OF_OFF[o]: m[:, a].reshape(ny, nx)
              for a, o in enumerate(_OFFS9)}

    # symmetrize: M[p, p+o] <- (M[p, p+o] + M[p+o, p]) / 2
    pairs = ((( 1, 0), (-1, 0)), ((0, 1), (0, -1)),
             (( 1, 1), (-1, -1)), ((1, -1), (-1, 1)))
    for o_f, o_r in pairs:
        f_name, r_name = _FIELD_OF_OFF[o_f], _FIELD_OF_OFF[o_r]
        f_val, r_val = fields[f_name], fields[r_name]
        # counterpart of forward entry at p: reverse entry at p+o_f
        fields[f_name] = 0.5 * (f_val + sh(r_val, o_f[1], o_f[0]))
        fields[r_name] = 0.5 * (r_val + sh(f_val, o_r[1], o_r[0]))

    dt = op.center.dtype      # follow the operator (e.g. an fp32 solve
    #                           under an fp64 config keeps f32 stencils)
    return Precond9(**{k: jnp.asarray(v, dt) for k, v in fields.items()})


def pcg_lanczos_eigs(cfg: ModelConfig, op: BtropOperator, bc: BC,
                     precond: Precond9, n_iter: int = None, seed: int = 0
                     ) -> Tuple[float, float]:
    """Extreme eigenvalues of the PRECONDITIONED operator M^-1 A for a
    general (9-pt) preconditioner, via the CG-Lanczos coefficient
    identity: running PCG on (-A)x = b with M' = -M yields alpha/beta
    whose tridiagonal T_kk = 1/alpha_k + beta_{k-1}/alpha_{k-1},
    T_{k,k+1} = sqrt(beta_k)/alpha_k has the Ritz values of M^-1 A.
    (The diagonal-preconditioner case keeps the plain Lanczos pass,
    lanczos_eigs.) Host eigensolve at init, like the reference's ratqr
    (source/POP_SolversMod.F90:3122)."""
    if n_iter is None:
        n_iter = cfg.solver.lanczos_iterations
    if isinstance(precond, FSPAI9):
        minv = fspai_apply(precond, bc)
    else:
        p = precond

        def minv(r):
            return (p.center * r
                    + p.north * bc.n(r) + p.south * bc.s(r)
                    + p.east * bc.e(r) + p.west * bc.w(r)
                    + p.ne * bc.ne(r) + p.nw * bc.nw(r)
                    + p.se * bc.se(r) + p.sw * bc.sw(r))

    mask = np.asarray(op.mask)

    rng = np.random.RandomState(seed)
    r0 = jnp.asarray(rng.rand(*mask.shape) * mask)
    mask_j = jnp.asarray(mask, r0.dtype)

    @jax.jit
    def run(r0):
        z0 = -minv(r0) * mask_j
        rz0 = jnp.sum(r0 * z0)

        def body(carry, _):
            r, z, p, rz_old = carry
            q = -apply_op(op, p, bc) * mask_j
            pq = jnp.sum(p * q)
            alpha = rz_old / jnp.where(pq != 0.0, pq, 1.0)
            r_new = r - alpha * q
            z_new = -minv(r_new) * mask_j
            rz = jnp.sum(r_new * z_new)
            beta = rz / jnp.where(rz_old != 0.0, rz_old, 1.0)
            p_new = z_new + beta * p
            return (r_new, z_new, p_new, rz), (alpha, beta, rz)

        _, (al, be, rz) = jax.lax.scan(body, (r0, z0, z0, rz0), None,
                                       length=n_iter)
        return al, be, rz

    al, be, rz = (np.asarray(v, np.float64) for v in run(r0))
    # truncate once the recurrence degenerates (rz ~ 0 or nonpositive)
    good = np.nonzero(~((rz > 0) & np.isfinite(al) & (al > 0)))[0]
    ncut = int(good[0]) if good.size else n_iter
    ncut = max(ncut, 2)
    al, be = al[:ncut], be[:ncut]
    diag = 1.0 / al
    diag[1:] += be[:-1] / al[:-1]
    offd = np.sqrt(np.maximum(be[:-1], 0.0)) / al[:-1]
    T = np.diag(diag) + np.diag(offd, 1) + np.diag(offd, -1)
    eigs = np.linalg.eigvalsh(T)
    emin = float(np.min(eigs)) / 1.05
    emax = float(np.max(eigs)) * 1.05
    return emin, emax


class FSPAI9(NamedTuple):
    """Factored sparse approximate inverse: a 9-point stencil G with
    M = -G^T G ~ A^-1 (A negative definite). Unlike the plain SPAI
    (build_spai9), whose symmetrized stencil can be INDEFINITE — measured
    on gx1v7: smallest eig of -M ~ -1.2e-5 against +1.5e-4 largest, which
    silently breaks CG — the factored form is SPD by construction."""
    center: jnp.ndarray
    north: jnp.ndarray
    south: jnp.ndarray
    east: jnp.ndarray
    west: jnp.ndarray
    ne: jnp.ndarray
    nw: jnp.ndarray
    se: jnp.ndarray
    sw: jnp.ndarray


def build_fspai9(cfg: ModelConfig, op: BtropOperator,
                 triangular: bool = True) -> FSPAI9:
    """Build G on the host: per ocean point p, the row g_p supported on
    its 9-point neighborhood solving the LOCAL SPD system
    (-A)[S_p, S_p] y = e_p, normalized g_p = y / sqrt(y_p) (the
    factored-SPAI / Kaporin row; the local matrices are principal
    submatrices of an SPD matrix, hence SPD). With ``triangular`` the
    support is restricted to lexicographically LOWER neighbors — the
    classical FSPAI structure approximating the inverse Cholesky factor
    (the unconstrained full-sparsity variant measured WORSE than diagonal
    preconditioning on the test grid: kappa 3000 vs 112). Assembled
    batched: the 9x9 local matrices are gathers of the row stencils."""
    from pop2_tpu.grid import _np_shift
    ew = cfg.ew_boundary
    ny, nx = op.center.shape

    def sh(f, di, dj):
        return _np_shift(f, di, dj, ew, "closed", 0.0, "center", "scalar")

    w1 = _row_stencils(op, sh)
    w1 = {o: -w for o, w in w1.items()}          # -A: SPD
    mask = np.asarray(op.mask) * (np.asarray(op.center) != 0.0)

    P = ny * nx
    L = np.zeros((P, 9, 9))
    valid = np.zeros((P, 9), bool)
    J, I = np.mgrid[0:ny, 0:nx]
    lex = (J * nx + I).ravel()
    for a, (dja, dia) in enumerate(_OFFS9):
        ok = (sh(mask, dia, dja) > 0).ravel()
        if triangular and a > 0:
            # neighbor index in the lex order (cyclic E-W wraps the
            # column index, which keeps the structure triangular except
            # at the seam column — fine for a preconditioner)
            jn = J + dja
            in_ = (I + dia) % nx if ew == "cyclic" else I + dia
            inside = (jn >= 0) & (jn < ny) & (in_ >= 0) & (in_ < nx)
            lex_n = np.where(inside, jn * nx + np.clip(in_, 0, nx - 1), -1)
            ok = ok & (lex_n.ravel() < lex) & (lex_n.ravel() >= 0)
        valid[:, a] = ok
        for bb, (djb, dib) in enumerate(_OFFS9):
            o = (djb - dja, dib - dia)
            if o in w1:
                L[:, a, bb] = sh(w1[o], dia, dja).ravel()

    act = valid[:, :, None] & valid[:, None, :]
    L = np.where(act, L, 0.0)
    eye = np.eye(9)[None]
    # inactive support points get unit diagonal (decoupled); land rows
    # get the identity so the batched solve stays nonsingular
    L = L + eye * (~valid)[:, :, None] * (~valid)[:, None, :] * 0.0
    for a in range(9):
        L[:, a, a] = np.where(valid[:, a], L[:, a, a], 1.0)
    L[~valid[:, 0]] = eye

    e0 = np.zeros((P, 9))
    e0[:, 0] = 1.0
    y = np.linalg.solve(L, e0[..., None])[..., 0]
    yp = np.maximum(y[:, 0], 1e-300)
    G = y / np.sqrt(yp)[:, None]
    G = np.where(valid, G, 0.0)
    G[~valid[:, 0]] = 0.0

    dt = op.center.dtype
    fields = {_FIELD_OF_OFF[o]: jnp.asarray(G[:, a].reshape(ny, nx), dt)
              for a, o in enumerate(_OFFS9)}
    return FSPAI9(**fields)


_OFF_OF_FIELD = {v: k for k, v in _FIELD_OF_OFF.items()}
_REV_FIELD = {"center": "center", "north": "south", "south": "north",
              "east": "west", "west": "east", "ne": "sw", "sw": "ne",
              "nw": "se", "se": "nw"}


def fspai_apply(p: FSPAI9, bc: BC):
    """Closure computing z = M r = -(G^T (G r)): two 9-point passes.
    G^T's weight for offset o at point p is G's weight for offset -o
    evaluated at p+o, so the transpose apply shifts the products."""
    def bsh(f, name):
        return getattr(bc, {"center": None, "north": "n", "south": "s",
                            "east": "e", "west": "w", "ne": "ne",
                            "nw": "nw", "se": "se", "sw": "sw"}[name])(f) \
            if name != "center" else f

    def apply(r):
        gr = sum(getattr(p, f_) * bsh(r, f_) for f_ in FSPAI9._fields)
        # (G^T v)[q] = sum_o G[q+o, q] v[q+o] = sum_o bsh_o(G_rev(o) * v)
        gtv = sum(bsh(getattr(p, _REV_FIELD[f_]) * gr, f_)
                  for f_ in FSPAI9._fields)
        return -gtv
    return apply


def scale_fspai(p: FSPAI9, si, bc: BC) -> FSPAI9:
    """G~ = G S^-1 for the scaled system: M~ = S^-1 M S^-1 =
    -(G S^-1)^T (G S^-1). Per-offset: G~_o[p] = G_o[p] * si[p+o]."""
    def bsh(f, name):
        return getattr(bc, {"north": "n", "south": "s", "east": "e",
                            "west": "w", "ne": "ne", "nw": "nw",
                            "se": "se", "sw": "sw"}[name])(f)
    vals = {}
    for f_ in FSPAI9._fields:
        w = getattr(p, f_)
        vals[f_] = w * (si if f_ == "center" else bsh(si, f_))
    return FSPAI9(**vals)
