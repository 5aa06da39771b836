"""Bit-for-bit reproducible reductions (the reference's b4b_flag,
mpi/global_reductions.F90:134,599; enabled via source/initial.F90:730-741).

Scope of the guarantee (documented, advisor-verified): with cfg.b4b every
GLOBAL REDUCTION (solver dot products, diagnostics, budgets) produces
identical bits on any mesh decomposition — the fixed-point limb sums are
order-independent by construction. Full-state bitwise equality across
decompositions is NOT achievable under XLA SPMD: the partitioner compiles
elementwise fusions (FMA contraction, excess precision) differently per
program, so even a pure 9-point stencil apply differs by ~1 ulp across mesh
shapes (verified empirically; --xla_allow_excess_precision=false does not
close it). The reference gets full-state b4b only because its Fortran
per-block loops are compiled ONCE for every layout — an option XLA does not
offer. What b4b buys here is what it buys the reference operationally:
identical solver convergence paths (iteration counts) and reduction-level
reproducibility, with state agreement at the ulp level.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pop2_tpu.config import get_config
from pop2_tpu.model import Model
from pop2_tpu.parallel import mesh as pmesh
from pop2_tpu.reductions import global_sum


def test_b4b_sum_order_independent():
    """The fixed-point sum gives identical bits for any summation order and
    stays within a few ulps of the float sum."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 96) * np.logspace(-8, 8, 64 * 96).reshape(64, 96)
    ref = float(global_sum(jnp.asarray(x), b4b=True))
    for perm in range(4):
        xs = x.flatten()
        rng.shuffle(xs)
        got = float(global_sum(jnp.asarray(xs.reshape(96, 64)), b4b=True))
        assert got == ref  # bitwise
    assert abs(ref - x.sum()) <= 1e-12 * abs(x.sum()) + 1e-300


def test_b4b_sum_handles_zeros_and_axis():
    z = jnp.zeros((4, 5))
    assert float(global_sum(z, b4b=True)) == 0.0
    x = jnp.asarray(np.random.RandomState(1).randn(3, 8, 9))
    per = global_sum(x, b4b=True, axis=(1, 2))
    assert per.shape == (3,)
    np.testing.assert_allclose(np.asarray(per), np.asarray(x).sum((1, 2)),
                               rtol=1e-12)


def test_b4b_sum_bitwise_across_sharding(cpu_devices8):
    """The core b4b invariant: a jitted global_sum over a (4,2)-sharded
    array returns IDENTICAL BITS to the single-device sum (the int64 limb
    psums are exact in any combine order)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    rng = np.random.RandomState(2)
    x = rng.randn(128, 128) * np.logspace(-6, 6, 128 * 128).reshape(128, 128)
    x = jnp.asarray(x)
    ref = float(jax.jit(lambda a: global_sum(a, b4b=True))(x))
    mesh = pmesh.make_mesh((4, 2), cpu_devices8)
    xs = jax.device_put(x, NamedSharding(mesh, P("y", "x")))
    got = float(jax.jit(lambda a: global_sum(a, b4b=True))(xs))
    assert got == ref  # bitwise across decompositions


def test_b4b_step_across_mesh(cpu_devices8):
    """Full steps single-device vs a (4,2) mesh with b4b on: solver
    iteration counts (driven by b4b dot products) must be IDENTICAL, and
    the state must agree at the ulp level (full bitwise state equality is
    impossible under XLA SPMD — see module docstring)."""
    cfg = get_config("mini").with_(b4b=True)
    m1 = Model(cfg)
    st1 = m1.initial_state()
    for _ in range(5):
        st1, d1 = m1.advance(st1)

    cfg8 = cfg.with_(mesh_shape=(4, 2))
    m8, mesh = pmesh.sharded_model(cfg8)
    st8 = pmesh.shard_pytree(m8.initial_state(), mesh)
    for _ in range(5):
        st8, d8 = m8.advance(st8)

    assert int(d1.solver_iters) == int(d8.solver_iters)
    for name in ("tracer_cur", "u_cur", "v_cur", "psurf_cur"):
        a = np.asarray(getattr(st1, name))
        b = np.asarray(getattr(st8, name))
        scale = np.abs(a).max() + 1e-300
        np.testing.assert_allclose(
            a, b, rtol=0.0, atol=1e-12 * scale,
            err_msg=f"{name} differs across decompositions beyond ulp level")


@pytest.mark.chip
def test_b4b_sum_on_gpu(gpu):
    """The b4b sum compiles for the GPU and gives the CPU's bits."""
    rng = np.random.RandomState(4)
    x = rng.randn(64, 128) * np.logspace(-6, 6, 64 * 128).reshape(64, 128)
    ref = float(global_sum(jnp.asarray(x), b4b=True))
    got = float(jax.jit(lambda a: global_sum(a, b4b=True))(
        jax.device_put(x, gpu)))
    assert got == ref
