"""Tripole northern-boundary fold.

Reference: ``mpi/POP_HaloMod.F90`` — the tripole branch gathers the top
``haloWidth+1`` physical rows into a shared buffer and fills northern ghost
cells with index-reversed (and sign-flipped, for vector fields) copies
(:1961-2050); the mapping depends on the field's horizontal location:

  location    i-mapping         j-mapping (ghost n = 1..halo)
  center      i -> nx+1-i       ghost row ny+n  <- phys row ny+1-n
  NE corner   i -> nx-i         ghost row ny+n  <- phys row ny-n
  E face      i -> nx-i         ghost row ny+n  <- phys row ny+1-n
  N face      i -> nx+1-i       ghost row ny+n  <- phys row ny-n

(1-based indices; offsets from the ioffset/joffset logic at :1961-2013).
For corner/N-face fields the top physical row lies ON the fold and is
degenerate: each point coincides with its mirror, so symmetry is enforced by
averaging the |values| with the partner's sign (:1977-1986).

Vector fields flip sign across the fold (isign = -1, :1936-1956).

The fold is a static-index gather (a reverse + roll on the top
rows), fully expressible as XLA ops; under pjit the reversed row exchange
becomes a collective-permute pattern across the x-axis of the mesh.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["fold_rows", "shift_n_tripole", "enforce_top_symmetry"]


def _rev_center(row):
    """i -> nx+1-i (1-based) == reverse (0-based i -> nx-1-i)."""
    return row[..., ::-1]


def _rev_corner(row):
    """i -> nx-i (1-based) == 0-based i -> nx-2-i, with i=nx-1 -> nx-1
    (the iSrc==0 -> nxGlobal wrap of the reference)."""
    return jnp.roll(row[..., ::-1], -1, axis=-1)


def fold_rows(f, n: int, loc: str = "center", kind: str = "scalar"):
    """Value of ghost row ny-1+n (0-based; n = 1..halo) under the fold.

    f: (..., ny, nx). Returns (..., nx).
    """
    ny = f.shape[-2]
    if loc == "center":
        out = _rev_center(f[..., ny - n, :])
    elif loc == "necorner":
        out = _rev_corner(f[..., ny - 1 - n, :])
    elif loc == "eface":
        out = _rev_corner(f[..., ny - n, :])
    elif loc == "nface":
        out = _rev_center(f[..., ny - 1 - n, :])
    else:
        raise ValueError(f"unknown location {loc}")
    return -out if kind == "vector" else out


def shift_n_tripole(f, dist: int = 1, loc: str = "center",
                    kind: str = "scalar"):
    """f shifted so result[j] = f[j+dist], with northern ghost values from
    the tripole fold. dist in {1, 2}."""
    ny = f.shape[-2]
    g = jnp.roll(f, -dist, axis=-2)
    for n in range(1, dist + 1):
        # output row ny-dist-1+n holds input ghost row ny-1+n
        g = g.at[..., ny - 1 - dist + n, :].set(fold_rows(f, n, loc, kind))
    return g


def enforce_top_symmetry(f, loc: str = "necorner", kind: str = "vector"):
    """Enforce the degenerate-top-row symmetry for corner/N-face fields
    (mpi/POP_HaloMod.F90:1977-1986): each top-row point and its fold partner
    get the average magnitude with their own signs (times isign for
    vectors)."""
    sign = -1.0 if kind == "vector" else 1.0
    top = f[..., -1, :]
    if loc == "necorner":
        partner = _rev_corner(top)
    elif loc == "nface":
        partner = _rev_center(top)
    else:
        return f
    avg = 0.5 * (jnp.abs(top) + jnp.abs(partner))
    newtop = sign * jnp.sign(partner) * avg
    return f.at[..., -1, :].set(newtop)


def reduction_weights(ny: int, nx: int, loc: str = "center",
                      dtype=None):
    """Weights for global reductions on a tripole grid: for NE-corner and
    N-face fields the top physical row is redundant beyond the first half of
    the domain (mpi/global_reductions.F90:226-240); those points get weight
    zero. Center/E-face fields need no correction. Returns (ny, nx)."""
    import numpy as np
    w = np.ones((ny, nx))
    if loc in ("necorner", "nface"):
        w[-1, nx // 2:] = 0.0
    return jnp.asarray(w, dtype)
