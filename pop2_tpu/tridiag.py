"""Batched implicit vertical-mixing tridiagonal solves.

Port of the Thomas-algorithm sweeps of ``source/vertical_mix.F90:1164``
(impvmixt), ``:1460`` (impvmixt_correct) and ``:1679`` (impvmixu): one
``lax.scan`` down the column (forward elimination) and one reversed scan
(back substitution), vectorized over every (ny,nx) column. The k dimension
is small (20-62) and sequential by nature; all the parallelism lives in the
horizontal. On a GPU the same sweep runs as one Pallas kernel
(``tridiag_pallas.py``).

System solved per column (no partial bottom cells), for the increment F:

  (hfac_k + A_k + C_k) F_k - A_k F_{k+1} - C_k F_{k-1} = hfac_k * RHS_k

with hfac_k = dz_k / c2dt_k, A_k = aidif * VDC_k / dzw_k (zero at/below the
column bottom), C_k = A_{k-1}, and a surface-layer thickness correction
H1 = hfac_1 + PSURF/(g*c2dt_1) for the variable-thickness surface layer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pop2_tpu import constants as const


def _as3(a, km):
    """(km,) profile -> (km, 1, 1); pass 3-D thickness arrays through."""
    return a if a.ndim == 3 else jnp.reshape(a, (km, 1, 1))


def _mid_spacing_r(dz, dzwr, km):
    """Reciprocal interface spacing below each layer. For 1-D profiles use
    the precomputed dzwr (bitwise-identical to the historical path); for
    3-D partial-bottom-cell thickness compute 1/(0.5*(dz_k + dz_{k+1}))
    (vertical_mix.F90 partial_bottom_cells branches)."""
    if dz.ndim == 3:
        dz_kp1 = jnp.concatenate([dz[1:], dz[-1:]], axis=0)
        return 1.0 / (0.5 * (dz + dz_kp1))
    return jnp.reshape(dzwr[1:km + 1], (km, 1, 1))


def _thomas(hfac, H1, A, kmax, rhs_terms):
    """Shared forward-elimination / back-substitution sweep.

    Args:
      hfac: (km, 1, 1) or (km, ny, nx) diagonal mass terms dz_k/c2dt_k.
      H1: (ny, nx) surface-layer mass term (hfac_1 + psurf correction).
      A: (km, ny, nx) subdiagonal coupling aidif*VDC_k*dzwr_k (A_km unused).
      kmax: (ny, nx) int, deepest ocean level (1-based; 0 = land).
      rhs_terms: list of (km, ny, nx) right-hand sides hfac_k*RHS_k
        (multiple RHS share one factorization, e.g. U and V).

    Returns list of solutions F with F_k = 0 for k > kmax.
    """
    km = A.shape[0]
    nrhs = len(rhs_terms)
    hfac = jnp.broadcast_to(hfac, A.shape)
    kidx = jax.lax.broadcasted_iota(jnp.int32, A.shape, 0) + 1  # 1-based

    # level-1 setup (source/vertical_mix.F90:1263-1274)
    A1 = A[0]
    D1 = H1 + A1
    E1 = A1 / D1
    B1 = H1 * E1
    F1 = [rhs[0] / D1 for rhs in rhs_terms]

    def fwd(carry, xs):
        A_prev, B, F_prev = carry
        A_k, hfac_k, at_bottom, below_bottom, rhs_k = xs
        C = A_prev
        D = jnp.where(at_bottom, hfac_k + B, hfac_k + A_k + B)
        D = jnp.where(below_bottom, 1.0, D)  # avoid 0/0 on land
        E_k = jnp.where(below_bottom, 0.0, A_k / D)
        B_new = (hfac_k + B) * E_k
        F_k = [jnp.where(below_bottom, 0.0, (r + C * Fp) / D)
               for r, Fp in zip(rhs_k, F_prev)]
        return (A_k, B_new, F_k), (E_k, F_k)

    xs = (
        A[1:],
        hfac[1:],
        (kidx[1:] == kmax[None]),
        (kidx[1:] > kmax[None]),
        [rhs[1:] for rhs in rhs_terms],
    )
    (_, _, _), (E_rest, F_rest) = jax.lax.scan(
        fwd, (A1, B1, F1), xs)

    E = jnp.concatenate([E1[None], E_rest], axis=0)
    F = [jnp.concatenate([F1[n][None], F_rest[n]], axis=0)
         for n in range(nrhs)]

    # back substitution (source/vertical_mix.F90:1338-1349): for k < kmax,
    # F_k += E_k * F_{k+1}, sweeping km-1 .. 1
    def bwd(F_above, xs):
        E_k, F_k, interior = xs
        F_new = [jnp.where(interior, Fk + E_k * Fa, Fk)
                 for Fk, Fa in zip(F_k, F_above)]
        return F_new, F_new

    interior = kidx < kmax[None]
    xs_rev = (E[:-1][::-1], [f[:-1][::-1] for f in F], interior[:-1][::-1])
    _, F_upd_rev = jax.lax.scan(bwd, [f[-1] for f in F], xs_rev)
    out = []
    for n in range(nrhs):
        upper = F_upd_rev[n][::-1]
        out.append(jnp.concatenate([upper, F[n][-1][None]], axis=0))
    return out


def _coupling(vdc, dz, dzwr, km, aidif):
    """Subdiagonal coupling A_k = aidif*VDC_k/dzw_k, zero on the bottom
    level (no flux through the bottom of the grid)."""
    A = aidif * _mid_spacing_r(dz, dzwr, km) * vdc
    return A.at[-1].set(0.0)


def _solve(hfac, H1, A, kmax, rhs):
    """Solve every column's system for each of ``rhs`` (nr, km, ny, nx),
    unscaled; all right-hand sides share one factorization.

    With a 1-D thickness the Pallas kernel (tridiag_pallas.py) solves when
    the computation is lowered for CUDA, the lax.scan sweep elsewhere; 3-D
    (partial bottom cell) thickness always takes the scan."""
    def scan(hfac, H1, kmax, A, rhs):
        hfac = jnp.reshape(hfac, (-1,) + (1,) * (A.ndim - 1)) \
            if hfac.ndim == 1 else hfac
        return jnp.stack(_thomas(hfac, H1, A, kmax, [hfac * r for r in rhs]))

    if hfac.shape[1:] != (1, 1):
        return scan(hfac, H1, kmax, A, rhs)
    from pop2_tpu import tridiag_pallas
    return tridiag_pallas.thomas(jnp.reshape(hfac, (-1,)), H1, kmax, A, rhs,
                                 fallback=scan)


def impvmixt_batch(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
                   varthick: bool):
    """Multi-tracer implicit mixing: all tracers in ``rhs`` (nr, km, ny, nx)
    use the same diffusivity ``vdc`` (km, ny, nx) and so one factorization.
    Arguments otherwise as ``impvmixt``; returns (nr, km, ny, nx)."""
    km = rhs.shape[1]
    c2dtt = jnp.reshape(c2dtt, (km, 1, 1))
    hfac = _as3(dz, km) / c2dtt
    A = _coupling(vdc, dz, dzwr, km, aidif)
    H1 = hfac[0] + (psurf / (const.GRAV * c2dtt[0, 0, 0])
                    if varthick else 0.0)
    H1 = jnp.broadcast_to(H1, rhs.shape[2:])
    return _solve(hfac, H1, A, kmt, rhs)


def impvmixt(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
             varthick: bool):
    """Implicit tracer mixing: solve for the increment dT
    (source/vertical_mix.F90:1164-1382).

    Args:
      rhs: (km, ny, nx) explicit RHS, already multiplied by c2dtt (the
        reference's TNEW on input).
      vdc: (km, ny, nx) diffusivity at layer bottoms for this tracer.
      psurf: (ny, nx) surface pressure on the system's LHS at k=1.
      kmt: (ny, nx) deepest level.
      c2dtt: (km,) effective timestep per level.

    Returns dT, (km, ny, nx); caller forms T_new = T_old + dT.
    """
    return impvmixt_batch(rhs[None], vdc, psurf, kmt, dz, dzwr, c2dtt,
                          aidif, varthick)[0]


def impvmixt_correct(rhs1, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif: float,
                     varthick: bool):
    """Corrector-step variant (source/vertical_mix.F90:1460-1672): only the
    k=1 RHS is nonzero; it propagates down through the C*F_{k-1} coupling.

    rhs1: (ny, nx) surface right-hand side.
    Returns the correction dT, (km, ny, nx).
    """
    km = vdc.shape[0]
    rhs = jnp.zeros((km,) + rhs1.shape, rhs1.dtype).at[0].set(rhs1)
    return impvmixt(rhs, vdc, psurf, kmt, dz, dzwr, c2dtt, aidif, varthick)


def impvmixu(rhs_u, rhs_v, vvc, kmu, dz, dzwr, c2dtu, aidif: float):
    """Implicit momentum mixing (source/vertical_mix.F90:1679-1881): solves
    for the modified RHS (already times c2dtu); the two components share one
    factorization. Returns (Fu, Fv)."""
    km = rhs_u.shape[0]
    hfac = _as3(dz, km) / c2dtu
    A = _coupling(vvc, dz, dzwr, km, aidif)
    H1 = jnp.broadcast_to(hfac[0], rhs_u.shape[1:])
    out = _solve(hfac, H1, A, kmu, jnp.stack([rhs_u, rhs_v]))
    return out[0], out[1]
