"""Tridiagonal solver tests vs a dense direct solve (oracle)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pop2_tpu import tridiag


def _dense_solve(hfac, H1, A, kmax, rhs):
    """Build and solve the dense system for one column (oracle).

    Row k (0-based, k < kmax):
      (hfac_k + A_k*(k<kmax-1) + A_{k-1}*(k>0)) F_k
         - A_k F_{k+1} - A_{k-1} F_{k-1} = hfac_k*rhs_k
    with the k=0 mass term replaced by H1.
    """
    n = kmax
    if n == 0:
        return np.zeros_like(rhs)
    M = np.zeros((n, n))
    b = np.zeros(n)
    for k in range(n):
        mass = H1 if k == 0 else hfac[k]
        diag = mass
        if k < n - 1:
            diag += A[k]
            M[k, k + 1] = -A[k]
        if k > 0:
            diag += A[k - 1]
            M[k, k - 1] = -A[k - 1]
        M[k, k] = diag
        b[k] = hfac[k] * rhs[k]
    F = np.zeros_like(rhs)
    F[:n] = np.linalg.solve(M, b)
    return F


def test_impvmixt_matches_dense():
    rng = np.random.RandomState(0)
    km, ny, nx = 10, 4, 5
    dz = rng.uniform(0.5, 2.0, km)
    dzw = np.zeros(km + 1)
    dzw[0] = 0.5 * dz[0]
    dzw[1:km] = 0.5 * (dz[:-1] + dz[1:])
    dzw[km] = 0.5 * dz[-1]
    dzwr = 1.0 / dzw
    c2dtt = np.full(km, 100.0)
    kmt = rng.randint(0, km + 1, (ny, nx))
    # physical coefficient fields are zero at/below the column bottom
    # (schemes mask to k < KMT)
    vdc = rng.uniform(0.0, 0.3, (km, ny, nx)) * (
        np.arange(1, km + 1)[:, None, None] < kmt[None])
    rhs = rng.randn(km, ny, nx) * (np.arange(1, km + 1)[:, None, None]
                                   <= kmt[None])
    psurf = rng.randn(ny, nx) * 100.0

    aidif = 1.0
    dT = np.asarray(tridiag.impvmixt(
        jnp.asarray(rhs), jnp.asarray(vdc), jnp.asarray(psurf),
        jnp.asarray(kmt), jnp.asarray(dz), jnp.asarray(dzwr),
        jnp.asarray(c2dtt), aidif, varthick=True))

    from pop2_tpu import constants as const
    hfac = dz / c2dtt
    for j in range(ny):
        for i in range(nx):
            n = kmt[j, i]
            A = aidif * dzwr[1:km + 1] * vdc[:, j, i]
            if n > 0:
                A = A.copy()
                A[n - 1:] = 0.0  # no flux through the column bottom
            H1 = hfac[0] + psurf[j, i] / (const.GRAV * c2dtt[0])
            expect = _dense_solve(hfac, H1, A, n, rhs[:, j, i])
            np.testing.assert_allclose(dT[:, j, i], expect, atol=1e-12,
                                       err_msg=f"column {j},{i} kmt={n}")


def test_impvmixu_matches_dense():
    rng = np.random.RandomState(1)
    km, ny, nx = 8, 3, 4
    dz = rng.uniform(0.5, 2.0, km)
    dzw = np.zeros(km + 1)
    dzw[0] = 0.5 * dz[0]
    dzw[1:km] = 0.5 * (dz[:-1] + dz[1:])
    dzw[km] = 0.5 * dz[-1]
    dzwr = 1.0 / dzw
    c2dtu = 50.0
    kmu = rng.randint(0, km + 1, (ny, nx))
    vvc = rng.uniform(0.0, 0.3, (km, ny, nx)) * (
        np.arange(1, km + 1)[:, None, None] < kmu[None])
    mask = np.arange(1, km + 1)[:, None, None] <= kmu[None]
    rhs_u = rng.randn(km, ny, nx) * mask
    rhs_v = rng.randn(km, ny, nx) * mask

    Fu, Fv = tridiag.impvmixu(
        jnp.asarray(rhs_u), jnp.asarray(rhs_v), jnp.asarray(vvc),
        jnp.asarray(kmu), jnp.asarray(dz), jnp.asarray(dzwr), c2dtu, 1.0)
    Fu, Fv = np.asarray(Fu), np.asarray(Fv)

    hfac = dz / c2dtu
    for j in range(ny):
        for i in range(nx):
            n = kmu[j, i]
            A = dzwr[1:km + 1] * vvc[:, j, i]
            if n > 0:
                A = A.copy()
                A[n - 1:] = 0.0
            eu = _dense_solve(hfac, hfac[0], A, n, rhs_u[:, j, i])
            ev = _dense_solve(hfac, hfac[0], A, n, rhs_v[:, j, i])
            np.testing.assert_allclose(Fu[:, j, i], eu, atol=1e-12)
            np.testing.assert_allclose(Fv[:, j, i], ev, atol=1e-12)


def test_impvmixt_correct_is_surface_propagation():
    rng = np.random.RandomState(2)
    km, ny, nx = 6, 2, 2
    dz = np.ones(km)
    dzw = np.concatenate([[0.5], np.ones(km - 1), [0.5]])
    dzwr = 1.0 / dzw
    c2dtt = np.full(km, 10.0)
    vdc = rng.uniform(0.1, 0.5, (km, ny, nx))
    kmt = np.full((ny, nx), km)
    rhs1 = rng.randn(ny, nx)
    psurf = np.zeros((ny, nx))

    dT = tridiag.impvmixt_correct(
        jnp.asarray(rhs1), jnp.asarray(vdc), jnp.asarray(psurf),
        jnp.asarray(kmt), jnp.asarray(dz), jnp.asarray(dzwr),
        jnp.asarray(c2dtt), 1.0, varthick=True)
    rhs = np.zeros((km, ny, nx))
    rhs[0] = rhs1
    dT2 = tridiag.impvmixt(
        jnp.asarray(rhs), jnp.asarray(vdc), jnp.asarray(psurf),
        jnp.asarray(kmt), jnp.asarray(dz), jnp.asarray(dzwr),
        jnp.asarray(c2dtt), 1.0, varthick=True)
    np.testing.assert_allclose(np.asarray(dT), np.asarray(dT2), atol=1e-14)


def _thomas_case(rng, dtype, nr, km, ny, nx, kmt):
    """Random well-posed systems in the kernel's argument convention."""
    from pop2_tpu import constants as const
    dz = rng.uniform(500.0, 2.0e4, km)
    dzw = np.concatenate([[0.5 * dz[0]], 0.5 * (dz[:-1] + dz[1:]),
                          [0.5 * dz[-1]]])
    c2dtt = np.full(km, 2.0 * 3600.0)
    vdc = rng.uniform(0.0, 50.0, (km, ny, nx)) * (
        np.arange(1, km + 1)[:, None, None] < kmt[None])
    rhs = rng.randn(nr, km, ny, nx)
    psurf = rng.randn(ny, nx) * 1.0e3
    hfac = jnp.asarray(dz / c2dtt, dtype)
    A = tridiag._coupling(jnp.asarray(vdc, dtype), jnp.asarray(dz, dtype),
                          jnp.asarray(1.0 / dzw, dtype), km, 1.0)
    h1 = hfac[0] + jnp.asarray(psurf, dtype) / float(const.GRAV * c2dtt[0])
    return hfac, h1, jnp.asarray(kmt), A, jnp.asarray(rhs, dtype)


def _scan_reference(hfac, h1, kmax, A, rhs):
    """The lax.scan sweep, all right-hand sides sharing one sweep."""
    h3 = jnp.reshape(hfac, (-1, 1, 1))
    return jnp.stack(tridiag._thomas(h3, h1, A, kmax, [h3 * r for r in rhs]))


_TOL = {jnp.float32: 1e-5, jnp.float64: 1e-12}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("nr", [1, 2, 5])
@pytest.mark.parametrize("grid_case", ["mini", "km60"])
def test_pallas_thomas_matches_scan(grid_case, nr, dtype, mini_grid):
    """The Thomas kernel (interpret mode) against the lax.scan sweep: the
    mini grid (land, kmt < km) and a km=60 column set whose point count is
    not a multiple of the block width."""
    from pop2_tpu import tridiag_pallas
    rng = np.random.RandomState(nr)
    if grid_case == "mini":
        kmt = np.asarray(mini_grid.KMT)
        km = mini_grid.kmask_t.shape[0]
    else:
        km, kmt = 60, rng.randint(0, 61, (5, 37))
        assert (5 * 37) % tridiag_pallas.BLOCK != 0
    args = _thomas_case(rng, dtype, nr, km, *kmt.shape, kmt)
    out = np.asarray(tridiag_pallas.thomas_blocks(*args, interpret=True))
    ref = np.asarray(_scan_reference(*args))
    assert out.dtype == ref.dtype == np.dtype(dtype)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=_TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("p", [1, 127, 128, 129, 320 * 384])
def test_thomas_layout_and_padding(p):
    """Block width is a power of two no wider than BLOCK; the padded point
    count covers P with less than one block of padding; padded columns do
    not disturb the real ones."""
    from pop2_tpu import tridiag_pallas
    bp, p_pad = tridiag_pallas.layout(p)
    assert bp & (bp - 1) == 0 and bp <= tridiag_pallas.BLOCK
    assert p_pad % bp == 0 and p <= p_pad < p + bp
    if p == 320 * 384:
        assert bp == tridiag_pallas.BLOCK and p_pad == p
        return
    rng = np.random.RandomState(p)
    kmt = rng.randint(0, 4, (1, p))
    args = _thomas_case(rng, jnp.float64, 2, 3, 1, p, kmt)
    out = np.asarray(tridiag_pallas.thomas_blocks(*args, interpret=True))
    np.testing.assert_allclose(out, np.asarray(_scan_reference(*args)),
                               rtol=0, atol=1e-12 * np.abs(out).max())


def test_impvmix_dispatch_takes_scan_off_gpu(mini_cfg, mini_grid):
    """Lowered for the CPU, the public solves take the scan: the jitted
    result equals the scan bit for bit, and no Triton call is lowered."""
    cfg, grid = mini_cfg, mini_grid
    km, ny, nx = cfg.km, cfg.ny, cfg.nx
    rng = np.random.RandomState(7)
    rhs = jnp.asarray(rng.randn(2, km, ny, nx))
    vdc = jnp.abs(jnp.asarray(rng.randn(km, ny, nx))) * 0.1
    psurf = jnp.asarray(rng.randn(ny, nx)) * 0.01
    c2dtt = jnp.full((km,), 2.0 * cfg.time.dtt)
    args = (rhs, vdc, psurf, grid.KMT, grid.vgrid.dz, grid.vgrid.dzwr,
            c2dtt, 1.0, True)
    fn = jax.jit(tridiag.impvmixt_batch, static_argnums=(7, 8))
    assert "triton" not in fn.lower(*args).as_text()
    out = np.asarray(fn(*args))
    ref = np.stack([np.asarray(tridiag.impvmixt(rhs[n], *args[1:]))
                    for n in range(2)])
    np.testing.assert_array_equal(out, ref)


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_thomas_kernel_on_gpu_matches_scan(gpu, dtype):
    """The compiled Triton kernel on the card against the scan at gx1v7
    widths (km=60, 384x320 columns)."""
    from pop2_tpu import tridiag_pallas
    rng = np.random.RandomState(0)
    kmt = rng.randint(0, 61, (384, 320))
    args = jax.device_put(_thomas_case(rng, dtype, 2, 60, 384, 320, kmt),
                          gpu)
    out = np.asarray(tridiag_pallas.thomas_blocks(*args))
    ref = np.asarray(jax.jit(_scan_reference)(*args))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=_TOL[dtype] * np.abs(ref).max())
