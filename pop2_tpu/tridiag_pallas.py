"""Pallas (Triton route) kernel for the batched implicit-vertical-mixing
tridiagonal solve on NVIDIA GPUs.

The plain path (``tridiag._thomas``) runs the Thomas sweep as two
``lax.scan``s over ``km``. On a GPU each scan trip is a handful of small
kernel launches, so the solve is bound by launch latency, not bytes. This
kernel runs the whole sweep for a block of columns in one program:

* the (ny, nx) horizontal is flattened to a point axis P and padded to a
  multiple of the block width ``bp`` (a power of two, so the per-level
  loads and stores along P are whole, coalesced vectors);
* one program per block of ``bp`` columns; a ``fori_loop`` over k does the
  forward elimination, carrying B, the previous level's coupling and the
  partial solutions F in registers, and writes E and F per level;
* a second ``fori_loop`` walks back up, reading E and F and carrying the
  level below in registers.

The Triton route has no scratch memory, so E goes out as a second result.
hfac (km,) is an ordinary input read one level at a time. Index arithmetic
is int32 throughout (the package enables x64 at import).

Arithmetic is the same per column and in the same order as
``tridiag._thomas`` (a port of source/vertical_mix.F90:1164, :1679), so the
two differ only by the GPU compiler's FMA contraction. The kernel covers the
1-D layer thickness case; 3-D (partial bottom cell) thickness keeps the scan.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Device mesh for per-shard dispatch, scoped (not module-global): each
#: Model's jitted step enters ``dispatch_mesh(model._mesh)`` at trace time,
#: so two models with different meshes never clobber each other. Columns
#: are independent, so under a (y, x)-sharded mesh the kernel runs per
#: shard inside ``jax.shard_map`` with no communication — as the reference
#: runs its per-block column loops on each rank's local blocks
#: (source/vertical_mix.F90:1164 block loop).
_DISPATCH_MESH = contextvars.ContextVar("pop2_tpu_dispatch_mesh",
                                        default=None)


@contextlib.contextmanager
def dispatch_mesh(mesh):
    """Scope the per-shard dispatch mesh for kernels traced inside."""
    token = _DISPATCH_MESH.set(mesh)
    try:
        yield
    finally:
        _DISPATCH_MESH.reset(token)


BLOCK = 128      # columns per program: one column per thread of 4 warps
NUM_WARPS = 4


def layout(p: int):
    """(columns per program, padded point count) for ``p`` columns: blocks
    of ``BLOCK``, or of the next power of two at or above ``p`` when that
    is smaller (tiny grids)."""
    bp = min(BLOCK, pl.next_power_of_2(max(p, 1)))
    return bp, pl.cdiv(p, bp) * bp


def _thomas_kernel(nr, km, hfac_ref, h1_ref, kmax_ref, a_ref, rhs_ref,
                   out_ref, e_ref):
    """One block of columns. hfac (km,); h1, kmax (bp,); a, e (km, bp);
    rhs, out (nr, km, bp)."""
    h1 = h1_ref[...]
    kmax = kmax_ref[...]

    # level-1 setup (source/vertical_mix.F90:1263-1274)
    a0 = a_ref[0, :]
    d1 = h1 + a0
    e1 = a0 / d1
    e_ref[0, :] = e1
    hf0 = hfac_ref[0]
    f1 = []
    for n in range(nr):
        f = (hf0 * rhs_ref[n, 0, :]) / d1
        out_ref[n, 0, :] = f
        f1.append(f)

    # forward elimination, levels 2..km
    def fwd(k, carry):
        a_prev, b, f_prev = carry
        kk = k + 1                       # 1-based level
        ak = a_ref[k, :]
        hf = hfac_ref[k]
        at_bot = kmax == kk
        below = kmax < kk
        d = jnp.where(at_bot, hf + b, hf + ak + b)
        d = jnp.where(below, 1.0, d)     # avoid 0/0 on land
        e = jnp.where(below, 0.0, ak / d)
        e_ref[k, :] = e
        f_new = []
        for n in range(nr):
            r = hf * rhs_ref[n, k, :]
            f = jnp.where(below, 0.0, (r + a_prev * f_prev[n]) / d)
            out_ref[n, k, :] = f
            f_new.append(f)
        return ak, (hf + b) * e, tuple(f_new)

    _, _, f_bot = jax.lax.fori_loop(
        jnp.int32(1), jnp.int32(km), fwd, (a0, h1 * e1, tuple(f1)))

    # back substitution (source/vertical_mix.F90:1338-1349): for k < kmax,
    # F_k += E_k * F_{k+1}, sweeping km-1 .. 1
    def bwd(j, f_dn):
        k = km - 2 - j
        ek = e_ref[k, :]
        interior = (k + 1) < kmax
        f_up = []
        for n in range(nr):
            fk = out_ref[n, k, :]
            f = jnp.where(interior, fk + ek * f_dn[n], fk)
            out_ref[n, k, :] = f
            f_up.append(f)
        return tuple(f_up)

    jax.lax.fori_loop(jnp.int32(0), jnp.int32(km - 1), bwd, f_bot)


@functools.partial(jax.jit, static_argnames=("interpret",))
def thomas_blocks(hfac, h1, kmax, a, rhs, interpret=False):
    """Solve the masked tridiagonal systems for every column.

    hfac: (km,) diagonal mass terms dz_k/c2dt_k.
    h1: (ny, nx) surface diagonal term (incl. psurf correction).
    kmax: (ny, nx) int deepest level (1-based; 0 = land).
    a: (km, ny, nx) subdiagonal coupling (zero on the bottom level).
    rhs: (nr, km, ny, nx) right-hand sides BEFORE the hfac scaling (the
      kernel forms hfac_k * rhs_k itself).
    Returns (nr, km, ny, nx) solutions.
    """
    nr, km = rhs.shape[0], rhs.shape[1]
    ny, nx = h1.shape
    p = ny * nx
    bp, p_pad = layout(p)

    def flat(x, lead, fill=0):
        x = jnp.reshape(x, lead + (p,))
        pad = [(0, 0)] * len(lead) + [(0, p_pad - p)]
        return jnp.pad(x, pad, constant_values=fill)

    dt = rhs.dtype
    h1f = flat(h1.astype(dt), (), fill=1)   # padded columns: land, D1 = 1
    kmaxf = flat(kmax.astype(jnp.int32), ())
    af = flat(a.astype(dt), (km,))
    rhsf = flat(rhs, (nr, km))

    zero = np.int32(0)               # int32 block indices under x64
    out, _ = pl.pallas_call(
        functools.partial(_thomas_kernel, nr, km),
        grid=(p_pad // bp,),
        in_specs=[
            pl.BlockSpec((km,), lambda i: (zero,)),
            pl.BlockSpec((bp,), lambda i: (i,)),
            pl.BlockSpec((bp,), lambda i: (i,)),
            pl.BlockSpec((km, bp), lambda i: (zero, i)),
            pl.BlockSpec((nr, km, bp), lambda i: (zero, zero, i)),
        ],
        out_specs=[
            pl.BlockSpec((nr, km, bp), lambda i: (zero, zero, i)),
            pl.BlockSpec((km, bp), lambda i: (zero, i)),
        ],
        out_shape=[jax.ShapeDtypeStruct((nr, km, p_pad), dt),
                   jax.ShapeDtypeStruct((km, p_pad), dt)],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="thomas_sweep",
    )(hfac.astype(dt), h1f, kmaxf, af, rhsf)
    return jnp.reshape(out[:, :, :p], (nr, km, ny, nx))


def thomas(hfac, h1, kmax, a, rhs, interpret=False, fallback=None):
    """Mesh-aware entry point, same arguments as ``thomas_blocks``.

    With ``fallback`` given, the kernel is chosen by the platform the
    computation is lowered for: the kernel for CUDA, ``fallback`` (same
    signature) anywhere else. Under an active ``dispatch_mesh`` scope the
    solve runs per shard inside ``jax.shard_map`` (the flatten/pad is then
    shard-local and never gathers); with no mesh in scope it is called
    directly."""
    kernel = functools.partial(thomas_blocks, interpret=interpret)

    def local(*args):
        if fallback is None:
            return kernel(*args)
        return jax.lax.platform_dependent(*args, cuda=kernel,
                                          default=fallback)

    mesh = _DISPATCH_MESH.get()
    if mesh is None:
        return local(hfac, h1, kmax, a, rhs)
    from jax.sharding import PartitionSpec as P
    yx = ("y", "x")
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(*yx), P(*yx), P(None, *yx), P(None, None, *yx)),
        out_specs=P(None, None, *yx),
        check_vma=False,  # pallas_call out_shape carries no vma info
    )(hfac, h1, kmax, a, rhs)
