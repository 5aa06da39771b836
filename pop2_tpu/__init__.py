"""pop2_tpu — an ocean dynamical core in JAX with the capabilities of POP2-CESM.

A brand-new implementation in JAX/XLA of a z-level, finite-difference,
hydrostatic, Boussinesq primitive-equation ocean general circulation model on an
Arakawa B-grid with an implicit free surface (the model family of
ESCOMP/POP2-CESM), redesigned as one array program:

  * global dense arrays + ``jax.sharding`` replace the reference's block
    decomposition + MPI halo machinery (reference: ``source/blocks.F90``,
    ``mpi/POP_HaloMod.F90``); XLA inserts halo exchanges for stencils on
    sharded arrays,
  * one jitted functional ``step`` replaces the reference's mutable
    3-time-level rotation (``source/step_mod.F90:126``),
  * batched vertical tridiagonal solves are ``lax.scan`` sweeps vectorized
    over all columns (``source/vertical_mix.F90:1164``), one Pallas
    kernel on a GPU,
  * the barotropic elliptic solve is a fused ``lax.while_loop`` CG-family
    solver (ChronGear / PCSI / PCG, ``source/POP_SolversMod.F90``).

fp64 is the working precision for parity with the reference; fp32 is the fast
mode for throughput. We enable x64 support at import so both are available;
all arrays are created with an explicit dtype from the model config.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from pop2_tpu.version import __version__  # noqa: E402,F401
