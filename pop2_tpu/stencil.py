"""B-grid shift and stencil operators.

Replacement for the reference's ghost-cell machinery: fields are
global dense arrays shaped ``(..., ny, nx)`` and neighbor access is expressed
with roll/pad shifts. Under ``pjit`` on a sharded mesh, XLA lowers these shifts
to halo exchanges (collective-permutes) automatically — this subsumes
``mpi/POP_HaloMod.F90`` (6956 lines of MPI ghost-cell updates) for the pure-jnp
path. Closed boundaries shift in zeros, matching the reference's
``fillValue = 0`` halo updates; cyclic boundaries wrap.

Index convention: array element ``[j, i]`` is the T-point (i,j) of the
reference (Fortran column-major (i,j) -> row-major [j,i]); the U-point [j, i]
is the NE corner of T-cell [j, i] (Arakawa B-grid; source/blocks.F90,
source/grid.F90 header comments).

Operators: 4-point divergence/gradient/curl (source/operators.F90:49,126,199),
T<->U-grid area-weighted averaging (source/grid.F90:3297-3420).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "shift_e", "shift_w", "shift_n", "shift_s",
    "shift_ne", "shift_nw", "shift_se", "shift_sw",
    "div", "grad", "zcurl", "tgrid_to_ugrid", "ugrid_to_tgrid",
]


def _shift_x(f, sign: int, bc: str):
    """sign=+1 -> value at (i+1) ('east'), sign=-1 -> value at (i-1)."""
    g = jnp.roll(f, -sign, axis=-1)
    zero = jnp.zeros((), g.dtype)
    if bc == "closed":
        if sign > 0:
            g = g.at[..., :, -1].set(zero)
        else:
            g = g.at[..., :, 0].set(zero)
    return g


def _shift_y(f, sign: int, bc: str):
    """sign=+1 -> value at (j+1) ('north'), sign=-1 -> value at (j-1)."""
    if bc == "tripole":
        if sign > 0:
            raise NotImplementedError(
                "northward shifts on tripole grids need the field "
                "location/kind; use BC.n / BC.nn / BC.n_partner")
        bc = "closed"  # the southern boundary of a tripole grid is closed
    g = jnp.roll(f, -sign, axis=-2)
    zero = jnp.zeros((), g.dtype)
    if bc == "closed":
        if sign > 0:
            g = g.at[..., -1, :].set(zero)
        else:
            g = g.at[..., 0, :].set(zero)
    return g


def shift_e(f, bc_ew: str = "cyclic"):
    """f[j, i+1]."""
    return _shift_x(f, +1, bc_ew)


def shift_w(f, bc_ew: str = "cyclic"):
    """f[j, i-1]."""
    return _shift_x(f, -1, bc_ew)


def shift_n(f, bc_ns: str = "closed"):
    """f[j+1, i]."""
    return _shift_y(f, +1, bc_ns)


def shift_s(f, bc_ns: str = "closed"):
    """f[j-1, i]."""
    return _shift_y(f, -1, bc_ns)


def shift_ne(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_n(shift_e(f, bc_ew), bc_ns)


def shift_nw(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_n(shift_w(f, bc_ew), bc_ns)


def shift_se(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_s(shift_e(f, bc_ew), bc_ns)


def shift_sw(f, bc_ew: str = "cyclic", bc_ns: str = "closed"):
    return shift_s(shift_w(f, bc_ew), bc_ns)


class BC:
    """Lightweight boundary-condition bundle used by all stencil ops."""

    __slots__ = ("ew", "ns")

    def __init__(self, ew: str = "cyclic", ns: str = "closed"):
        self.ew = ew
        self.ns = ns

    # shorthand shift methods. Northward shifts take the field's horizontal
    # location and kind, which select the tripole fold mapping
    # (mpi/POP_HaloMod.F90:1961-2050); ignored for closed/cyclic ns.
    # Southward and pure east/west shifts never cross the fold.
    def e(self, f):
        return shift_e(f, self.ew)

    def w(self, f):
        return shift_w(f, self.ew)

    def n(self, f, loc: str = "center", kind: str = "scalar"):
        if self.ns == "tripole":
            from pop2_tpu.tripole import shift_n_tripole
            return shift_n_tripole(f, 1, loc, kind)
        return shift_n(f, self.ns)

    def nn(self, f, loc: str = "center", kind: str = "scalar"):
        """Distance-2 northward shift (value at j+2)."""
        if self.ns == "tripole":
            from pop2_tpu.tripole import shift_n_tripole
            return shift_n_tripole(f, 2, loc, kind)
        return shift_n(shift_n(f, self.ns), self.ns)

    def n_partner(self, f, partner, loc: str = "center",
                  kind: str = "scalar"):
        """Northward shift of a south-face-type derived field whose tripole
        ghost values come from folding its north-face counterpart
        ``partner`` (the face-swap under the 180-degree fold; see e.g. the
        reference's ghost-zone evaluation of SLY(:,j+1,jsouth) in
        hmix_gm.F90). Equals ``n(f)`` for closed/cyclic boundaries."""
        if self.ns != "tripole":
            return shift_n(f, self.ns)
        from pop2_tpu.tripole import fold_rows
        g = jnp.roll(f, -1, axis=-2)
        return g.at[..., -1, :].set(fold_rows(partner, 1, loc, kind))

    def s(self, f):
        return shift_s(f, self.ns)

    def ne(self, f, loc: str = "center", kind: str = "scalar"):
        # fold first, then shift east: matches ghost-cell indexing
        return shift_e(self.n(f, loc, kind), self.ew)

    def nw(self, f, loc: str = "center", kind: str = "scalar"):
        return shift_w(self.n(f, loc, kind), self.ew)

    def se(self, f):
        return shift_s(shift_e(f, self.ew), self.ns)

    def sw(self, f):
        return shift_s(shift_w(f, self.ew), self.ns)

    def __eq__(self, other):
        return (isinstance(other, BC) and self.ew == other.ew
                and self.ns == other.ns)

    def __hash__(self):
        return hash((self.ew, self.ns))


# BC is pure static configuration: register it as a leafless pytree node so
# it can ride inside jitted-argument containers (e.g. tavg.TavgAux) without
# being treated as a traced array.
jax.tree_util.register_pytree_node(
    BC, lambda bc: ((), (bc.ew, bc.ns)), lambda aux, _: BC(*aux))


def div(ux, uy, dxu, dyu, mask_t, bc: BC):
    """Divergence (times T-cell area) at T points of a U-point vector field.

    4-point stencil (source/operators.F90:99-114): the T-point (i,j) gathers
    the 4 surrounding U-points (i,j), (i-1,j), (i,j-1), (i-1,j-1).
    ``mask_t`` is the (broadcastable) ocean mask at this level (k <= KMT).
    """
    a = ux * dyu
    b = uy * dxu
    out = 0.5 * (a + bc.s(a) - bc.w(a) - bc.sw(a)
                 + b + bc.w(b) - bc.s(b) - bc.sw(b))
    return jnp.where(mask_t, out, 0.0)


def grad(f, dxur, dyur, mask_u, bc: BC):
    """Gradient at U points of a T-point field.

    4-point stencil (source/operators.F90:178-187): U-point (i,j) gathers
    T-points (i,j), (i+1,j), (i,j+1), (i+1,j+1).
    Returns (gradx, grady); ``mask_u`` is the ocean mask at U points.
    """
    f_ne = bc.ne(f)
    f_e = bc.e(f)
    f_n = bc.n(f)
    gx = dxur * 0.5 * (f_ne - f - f_n + f_e)
    gy = dyur * 0.5 * (f_ne - f + f_n - f_e)
    zero = jnp.zeros_like(gx)
    return jnp.where(mask_u, gx, zero), jnp.where(mask_u, gy, zero)


def zcurl(ux, uy, dxu, dyu, mask_t, bc: BC):
    """z-component of curl (times T-cell area) at T points
    (source/operators.F90:254-265)."""
    a = ux * dxu
    b = uy * dyu
    out = 0.5 * (b + bc.s(b) - bc.w(b) - bc.sw(b)
                 - a - bc.w(a) + bc.s(a) + bc.sw(a))
    return jnp.where(mask_t, out, 0.0)


def tgrid_to_ugrid(f_t, au0, aun, aue, aune, bc: BC):
    """Area-weighted 4-point average from T points to U points
    (source/grid.F90:3403-3412): U(i,j) <- T(i,j), T(i,j+1), T(i+1,j),
    T(i+1,j+1) with precomputed area weights."""
    return (au0 * f_t + aun * bc.n(f_t) + aue * bc.e(f_t)
            + aune * bc.ne(f_t))


def ugrid_to_tgrid(f_u, bc: BC):
    """Simple 4-point average from U points to T points
    (source/grid.F90:3297-3355 with p25 weights, cf. cf_area_avg
    source/grid.F90:2908-2911)."""
    return 0.25 * (f_u + bc.s(f_u) + bc.w(f_u) + bc.sw(f_u))
