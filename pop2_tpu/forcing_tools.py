"""Forcing time-interpolation machinery.

Reference: ``source/forcing_tools.F90`` — monthly-climatology / n-hour
forcing data interpolated to model time with 'nearest', 'linear', or
'4point' (iterated-linear / Neville cubic, interp_4pt :1144-1238 and
det :1209-1238) interpolation.

Design: instead of the reference's mutable module state
(update windows, interp_last bookkeeping), a ``MonthlyClimatology`` is an
immutable pytree of the 12 stacked fields; interpolation to an arbitrary
model hour is a pure jit-friendly function of a traced scalar, so
time-varying forcing composes with ``lax.scan`` step fusion.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from pop2_tpu import pytree

HOURS_PER_YEAR = 365.0 * 24.0

_DAYS_IN_MONTH = np.array([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                          dtype=np.float64)


def midmonth_hours(data_type: str = "monthly-equal") -> np.ndarray:
    """Mid-month times in hours since year start
    (time_management thour00_midmonth_equal/calendar)."""
    if data_type == "monthly-equal":
        month = HOURS_PER_YEAR / 12.0
        return (np.arange(12) + 0.5) * month
    if data_type == "monthly-calendar":
        ends = np.cumsum(_DAYS_IN_MONTH) * 24.0
        starts = np.concatenate([[0.0], ends[:-1]])
        return 0.5 * (starts + ends)
    raise ValueError(f"unknown forcing data type {data_type}")


def _neville(tt, dd, t):
    """Cubic through 4 points by iterated linear interpolation
    (interp_4pt/det, forcing_tools.F90:1144-1238)."""
    def det(a, b, y, z):
        return (a * (z - t) - b * (y - t)) / (z - y)

    p12 = det(dd[0], dd[1], tt[0], tt[1])
    p23 = det(dd[1], dd[2], tt[1], tt[2])
    p34 = det(dd[2], dd[3], tt[2], tt[3])
    p123 = det(p12, p23, tt[0], tt[2])
    p234 = det(p23, p34, tt[1], tt[3])
    return det(p123, p234, tt[0], tt[3])


@pytree.dataclass
class MonthlyClimatology:
    """12 stacked monthly fields, shape (12, ...), with mid-month times."""
    data: jnp.ndarray
    times: jnp.ndarray                                    # (12,) hours
    interp: str = pytree.static_field(default="linear")

    @classmethod
    def create(cls, data, interp: str = "linear",
               data_type: str = "monthly-equal") -> "MonthlyClimatology":
        data = jnp.asarray(data)
        if data.shape[0] != 12:
            raise ValueError("monthly climatology needs leading axis 12")
        return cls(data=data, times=jnp.asarray(midmonth_hours(data_type)),
                   interp=interp)

    def at(self, thour) -> jnp.ndarray:
        """Interpolate to model hour (any year; periodic)."""
        t = jnp.asarray(thour, self.times.dtype) % HOURS_PER_YEAR
        # month whose midpoint is the last one <= t (may be -1 -> wraps)
        idx = jnp.searchsorted(self.times, t, side="right") - 1
        if self.interp == "nearest":
            lo = idx % 12
            hi = (idx + 1) % 12
            tlo = self.times[lo] + jnp.where(idx < 0, -HOURS_PER_YEAR, 0.0)
            thi = self.times[hi] + jnp.where(idx + 1 >= 12,
                                             HOURS_PER_YEAR, 0.0)
            pick = jnp.where(t - tlo <= thi - t, lo, hi)
            return self.data[pick]
        if self.interp == "linear":
            raw = idx + jnp.arange(2)
        elif self.interp == "4point":
            raw = idx + jnp.arange(-1, 3)
        else:
            raise ValueError(f"unknown interp type {self.interp}")
        ii = raw % 12
        tt = self.times[ii] + (raw // 12).astype(self.times.dtype) \
            * HOURS_PER_YEAR
        dd = self.data[ii]
        if self.interp == "linear":
            w = (tt[1] - t) / (tt[1] - tt[0])
            shape = (2,) + (1,) * (self.data.ndim - 1)
            w = jnp.stack([w, 1.0 - w]).reshape(shape)
            return jnp.sum(w * dd, axis=0)
        return _neville(tt, dd, t)


@pytree.dataclass
class TimeSeries:
    """Shared scalar/vector time-series forcing (CO2 records, CFC
    atmospheric histories): the counterpart of
    ``source/forcing_timeseries_mod.F90`` (forcing_timeseries_dataset:
    linear interpolation in model year with endpoint handling).

    data: (ntime, ...) values; years: (ntime,) decimal model years.
    """
    data: jnp.ndarray
    years: jnp.ndarray

    @classmethod
    def create(cls, years, data) -> "TimeSeries":
        years = jnp.asarray(years, jnp.result_type(float))
        data = jnp.asarray(data)
        if years.ndim != 1 or data.shape[0] != years.shape[0]:
            raise ValueError("TimeSeries needs matching leading axes")
        return cls(data=data, years=years)

    @classmethod
    def from_file(cls, path: str) -> "TimeSeries":
        """Whitespace-separated text: first column decimal year, remaining
        columns values (the reference reads netCDF; a text table carries
        the same content)."""
        import numpy as np
        raw = np.loadtxt(path)
        return cls.create(raw[:, 0], raw[:, 1:].squeeze())

    def at(self, year, taxmode: str = "extend"):
        """Linear interpolation at decimal model year
        (forcing_timeseries_mod.F90 taxmode semantics):
          'extend'      — clamp to the endpoint values outside the series;
          'extrapolate' — continue the slope of the first/last segment
                          beyond the endpoints (:taxmode_extrapolate).
        """
        t = jnp.asarray(year, self.years.dtype)
        if taxmode == "extend":
            t_eff = jnp.clip(t, self.years[0], self.years[-1])
        elif taxmode == "extrapolate":
            t_eff = t  # segment weights run outside [0, 1] at the ends
        else:
            raise NotImplementedError(f"taxmode {taxmode}")
        idx = jnp.clip(jnp.searchsorted(self.years, t_eff, side="right") - 1,
                       0, self.years.shape[0] - 2)
        t0, t1 = self.years[idx], self.years[idx + 1]
        w = jnp.where(t1 > t0,
                      (t_eff - t0) / jnp.where(t1 > t0, t1 - t0, 1.0),
                      0.0)
        lo = self.data[idx]
        hi = self.data[idx + 1]
        return lo + w * (hi - lo)
