"""Global reductions, with an optional bit-for-bit reproducible mode.

The reference treats bit-for-bit reproducibility of global sums across
PE decompositions as a first-class, tested invariant: its ``b4b_flag``
switches ``global_sum`` to per-block partial sums combined in a fixed block
order (``mpi/global_reductions.F90:134,599``; enabled from
``source/initial.F90:730-741``; exercised by PET/ERS system tests).

Under XLA the ordering hazard is different — it reduces shard-locally and
combines over the mesh, so a (4,2) mesh and a single device produce different
floating-point orderings — but the cure can be stronger than the
reference's: **order-independent fixed-point accumulation**. Each value is
split into three 30-bit integer limbs relative to the power-of-two ceiling
of the global absolute maximum; int64 sums of the limbs are exact
(associative), so ANY reduction order — any mesh shape, any XLA partition —
produces identical bits. The final 3-term float combine is a fixed-order
expression. Accuracy: values below max*2^-90 are dropped, far below one
fp64 ulp of the largest element (the reference's fixed-order sum keeps a
similar "round-off class" guarantee, not exactness).

Limb-sum overflow bound: |limb| < 2^31 per element, so int64 is exact for
up to 2^32 summands — comfortably above tx0.1's 3600*2400*62.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["global_sum"]

_P = 30  # bits per limb
_S1 = float(2 ** _P)
_S2 = float(2 ** (2 * _P))
_S3 = float(2 ** (3 * _P))


def _b4b_sum(x, axes):
    """Order-independent fixed-point sum of ``x`` over ``axes``."""
    absmax = jnp.max(jnp.abs(x))  # max is exact in any order
    # power-of-two scale >= absmax from floor(log2) + exp2, elementary
    # ops only. log2 may
    # round at exact powers of two, so the result is nudged up if it came
    # out below absmax — a 2x overestimate only spends one of the 90 limb
    # bits. Division by a power of two is exact, so y is an exact scaling.
    safe = jnp.where(absmax > 0, absmax, jnp.asarray(1.0, x.dtype))
    ex = jnp.floor(jnp.log2(safe)) + 1.0
    # exp2 of an integer-valued float is an exact power of two
    scale = jnp.exp2(ex.astype(x.dtype))
    scale = jnp.where(scale < safe, 2.0 * scale, scale)
    scale = jnp.where(absmax > 0, scale, jnp.asarray(1.0, x.dtype))
    y = x / scale  # |y| <= 1, exact

    r1 = jnp.round(y * _S1)
    y = y - r1 / _S1
    r2 = jnp.round(y * _S2)
    y = y - r2 / _S2
    r3 = jnp.round(y * _S3)

    s1 = jnp.sum(r1.astype(jnp.int64), axis=axes)
    s2 = jnp.sum(r2.astype(jnp.int64), axis=axes)
    s3 = jnp.sum(r3.astype(jnp.int64), axis=axes)
    # int64 -> float conversion: exact only while |limb sum| < 2^53 (i.e.
    # up to ~2^23 summands at the 2^30 per-element limb bound); beyond that
    # (e.g. tx0.1 3-D sums, ~2^29 elements) the conversion rounds — still
    # VALUE-DETERMINISTIC (same int64 in -> same float64 out on any mesh),
    # so the b4b guarantee holds; only the ~1-ulp accuracy claim weakens.
    # The combine order is a fixed 3-term expression.
    out = (s1.astype(x.dtype) / _S1
           + s2.astype(x.dtype) / _S2
           + s3.astype(x.dtype) / _S3) * scale
    return out


def global_sum(x, b4b: bool = False, axis=None):
    """Masked-field global sum. ``b4b=True`` selects the reproducible
    fixed-point path (identical bits on any mesh decomposition); the default
    is the straight ``jnp.sum`` (fastest, deterministic per compile).

    ``axis=None`` sums everything; otherwise sums the given trailing axes
    (used for per-tracer sums that keep the leading tracer axis).
    """
    if not b4b:
        return jnp.sum(x, axis=axis)
    if axis is None:
        axes = tuple(range(x.ndim))
    else:
        axes = axis if isinstance(axis, tuple) else (axis,)
    return _b4b_sum(x, axes)
