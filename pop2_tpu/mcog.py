"""Multi-column ocean grid (per-ice-category coupler shortwave columns).

Reference: ``source/mcog.F90`` — the coupler optionally delivers, per
CICE thickness category ("column"), the cell fraction ``frac_n``, the
radiative fraction ``fracr_n``, and the fraction-weighted shortwave
``fracr_qsw_n``. MCOG maps columns onto bins (``mcog_col_to_bin``),
normalizes the fractions to sum to 1 (with a capped adjustment that
preserves the fraction-weighted fluxes), checks the column/bin
aggregates against the coupler-aggregated shortwave, and exposes the
binned fields — consumed per-bin by the BGC interior forcing
(``source/ecosys_forcing_mod.F90:1551-1622``) and accumulated into
per-bin tavg fields.

The reference's per-point ``import_mcog`` loop
(``source/mcog.F90:578-717``) becomes one whole-field pass — the
column->bin segment sum is a tiny one-hot contraction over the leading
category axis, everything else is elementwise. The reference's abort on
aggregation mismatch becomes a host-side guard (``check_aggregation``),
matching the KE-guard pattern used elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

#: default abort threshold (W/m^2), source/mcog.F90:362
DAGG_QSW_ABORT_THRES = 1.0e-10
#: cap on |sum(frac)-1| used in the normalization, source/mcog.F90:288
MAX_FRAC_SUM_ANOM = 0.10


class McogBins(NamedTuple):
    """Binned MCOG fields (+ optional debug columns), the analogue of the
    module arrays FRAC_BIN/FRACR_BIN/QSW_RAW_BIN (source/mcog.F90:270-276)."""
    frac_bin: jnp.ndarray         # (nbins, ny, nx)
    fracr_bin: jnp.ndarray        # (nbins, ny, nx)
    qsw_raw_bin: jnp.ndarray      # (nbins, ny, nx)
    qsw_col_dagg: jnp.ndarray     # (ny, nx) col aggregate minus swnet
    qsw_bin_dagg: jnp.ndarray     # (ny, nx) bin aggregate minus swnet
    # debug columns (lmcog_debug): None unless requested
    frac_col: Optional[jnp.ndarray] = None      # (ncols, ny, nx)
    fracr_col: Optional[jnp.ndarray] = None
    qsw_raw_col: Optional[jnp.ndarray] = None
    frac_adjust: Optional[jnp.ndarray] = None   # (ny, nx)
    fracr_adjust: Optional[jnp.ndarray] = None


def _bin_matrix(col_to_bin: Sequence[int], nbins: int) -> np.ndarray:
    """(nbins, ncols) one-hot map: segment sums become a contraction."""
    ncols = len(col_to_bin)
    m = np.zeros((nbins, ncols))
    for c, b in enumerate(col_to_bin):
        if not 0 <= b < nbins:
            raise ValueError(f"col_to_bin[{c}]={b} outside 0..{nbins - 1}")
        m[b, c] = 1.0
    return m


def import_mcog(frac_col, fracr_col, qsw_fracr_col, swnet, kmt,
                col_to_bin: Sequence[int] = None, nbins: int = None,
                max_frac_sum_anom: float = MAX_FRAC_SUM_ANOM,
                debug: bool = False) -> McogBins:
    """Whole-field import of the per-column coupler fields
    (import_mcog, source/mcog.F90:578-717).

    frac_col/fracr_col/qsw_fracr_col: (ncols, ny, nx); swnet: (ny, nx)
    coupler-aggregated shortwave; kmt: (ny, nx) level counts (land = 0).
    ``col_to_bin`` is a 0-based column->bin index map (identity default).
    """
    ncols = frac_col.shape[0]
    if col_to_bin is None:
        col_to_bin = tuple(range(ncols))
    if nbins is None:
        nbins = max(col_to_bin) + 1
    ocean = (kmt > 0)
    zero = lambda a: jnp.where(ocean[None], a, 0.0)      # noqa: E731
    frac_col = zero(frac_col)
    fracr_col = zero(fracr_col)
    qsw_fracr_col = zero(qsw_fracr_col)
    swnet = jnp.where(ocean, swnet, 0.0)

    B = jnp.asarray(_bin_matrix(col_to_bin, nbins), frac_col.dtype)
    seg = lambda a: jnp.einsum(                          # noqa: E731
        "bc,cyx->byx", B, a, precision=jax.lax.Precision.HIGHEST)

    frac_bin = jnp.minimum(1.0, seg(frac_col))
    fracr_bin = jnp.minimum(1.0, seg(fracr_col))
    qsw_fracr_bin = seg(qsw_fracr_col)

    # aggregation consistency vs the coupler's own aggregate (:655-668)
    qsw_col_dagg = jnp.sum(qsw_fracr_col, axis=0) - swnet
    qsw_bin_dagg = jnp.sum(qsw_fracr_bin, axis=0) - swnet

    def unweight(qf, fr):
        return jnp.where(fr > 0.0, qf / jnp.where(fr > 0.0, fr, 1.0), 0.0)

    qsw_col = unweight(qsw_fracr_col, fracr_col)
    qsw_bin = unweight(qsw_fracr_bin, fracr_bin)

    # scale fractions to sum to 1, flux-product preserving, cap the
    # adjustment (:683-698)
    def frac_scale(fc):
        s = jnp.sum(fc, axis=0)
        return jnp.clip(s, 1.0 - max_frac_sum_anom, 1.0 + max_frac_sum_anom)

    frac_sum = frac_scale(frac_col)
    fracr_sum = frac_scale(fracr_col)
    frac_col = frac_col / frac_sum[None]
    frac_bin = frac_bin / frac_sum[None]
    fracr_col = fracr_col / fracr_sum[None]
    fracr_bin = fracr_bin / fracr_sum[None]
    qsw_col = qsw_col * fracr_sum[None]
    qsw_bin = qsw_bin * fracr_sum[None]

    out = McogBins(frac_bin=frac_bin, fracr_bin=fracr_bin,
                   qsw_raw_bin=qsw_bin, qsw_col_dagg=qsw_col_dagg,
                   qsw_bin_dagg=qsw_bin_dagg)
    if debug:
        out = out._replace(frac_col=frac_col, fracr_col=fracr_col,
                           qsw_raw_col=qsw_col,
                           frac_adjust=1.0 / frac_sum,
                           fracr_adjust=1.0 / fracr_sum)
    return out


def check_aggregation(bins: McogBins,
                      thresh: float = DAGG_QSW_ABORT_THRES) -> None:
    """Host-side analogue of the reference's abort on aggregation mismatch
    (source/mcog.F90:658-668). Call outside jit (like check_ke)."""
    import numpy as np_
    worst = max(float(np_.abs(np_.asarray(bins.qsw_col_dagg)).max()),
                float(np_.abs(np_.asarray(bins.qsw_bin_dagg)).max()))
    if worst > thresh:
        raise FloatingPointError(
            f"mcog qsw aggregation mismatch {worst:.3e} exceeds {thresh:g}")


def single_column_bins(swnet, kmt) -> McogBins:
    """lmcog = .false. behavior: one bin filled with the coupler
    aggregates (source/mcog.F90:102-104, 520-545)."""
    ocean = (kmt > 0)
    one = jnp.where(ocean, 1.0, 0.0)[None]
    q = jnp.where(ocean, swnet, 0.0)[None]
    z = jnp.zeros_like(swnet)
    return McogBins(frac_bin=one, fracr_bin=one, qsw_raw_bin=q,
                    qsw_col_dagg=z, qsw_bin_dagg=z)


def qsw_bin_weighted(bins: McogBins, wght) -> jnp.ndarray:
    """QSW_BIN = subcoupling weight x QSW_RAW_BIN — the coszen (or 12-hr)
    normalization applied to each bin exactly as to the aggregate
    (source/forcing.F90:395-414). ``wght`` broadcasts over bins."""
    return bins.qsw_raw_bin * wght


def tavg_field_names(nbins: int, debug: bool = False, ncols: int = 0):
    """Per-bin tavg field names mirroring the reference's registrations
    (init_mcog tavg defines, source/mcog.F90:470-565)."""
    names = []
    for nb in range(1, nbins + 1):
        names += [f"FRAC_BIN_{nb:02d}", f"FRACR_BIN_{nb:02d}",
                  f"QSW_BIN_{nb:02d}"]
    if debug:
        for nb in range(1, nbins + 1):
            names.append(f"QSW_RAW_BIN_{nb:02d}")
        for nc in range(1, ncols + 1):
            names += [f"FRAC_COL_{nc:02d}", f"FRACR_COL_{nc:02d}",
                      f"QSW_RAW_COL_{nc:02d}"]
        names += ["QSW_RAW_COL_DAGG", "QSW_RAW_BIN_DAGG",
                  "FRAC_ADJUST_FACT", "FRACR_ADJUST_FACT"]
    return names


# ---- aggregation helpers kept from the round-3 core --------------------

def normalize_fractions(frac_cat, eps: float = 1.0e-12):
    """Category fractions (ncat, ny, nx) normalized to sum to 1 over the
    categories present."""
    tot = jnp.sum(frac_cat, axis=0, keepdims=True)
    return jnp.where(tot > eps, frac_cat / jnp.maximum(tot, eps),
                     jnp.zeros_like(frac_cat))


def aggregate(frac_cat, field_cat):
    """Fraction-weighted aggregate of a per-category field: the mean flux
    the single-column ocean physics sees."""
    w = normalize_fractions(frac_cat)
    return jnp.sum(w * field_cat, axis=0)


def per_category_anomaly(frac_cat, field_cat):
    """Per-category deviation from the aggregate (diagnostic columns)."""
    agg = aggregate(frac_cat, field_cat)
    return field_cat - agg[None]
