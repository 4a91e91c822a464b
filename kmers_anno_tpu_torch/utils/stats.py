"""Summary statistics + Java-compatible double formatting.  A copy of
the reference package's ``utils/stats.py``.

The reference tool reports statistics through commons-math3
``SummaryStatistics`` (CheckAnnotationProcessor.java:114-115,
ApplyAnnotationProcessor.java:113) and prints them with
``Double.toString``.  Both are replicated here so report rows match byte
for byte:

* mean/min of an empty series = NaN; standard deviation of an empty series
  = NaN, of a single value = 0.0 (commons-math semantics);
* ``java_double`` follows Java's ``Double.toString``: "NaN", a ".0" suffix
  on integral values, and scientific notation (``1.0E-4``) outside
  [1e-3, 1e7).
"""

from __future__ import annotations

import math


class SummaryStatistics:
    """Streaming mean / min / sample standard deviation."""

    def __init__(self) -> None:
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._min = math.nan
        self._max = math.nan

    def add_value(self, x: float) -> None:
        self.n += 1
        delta = x - self._mean
        self._mean += delta / self.n
        self._m2 += delta * (x - self._mean)
        self._min = x if self.n == 1 else min(self._min, x)
        self._max = x if self.n == 1 else max(self._max, x)

    @property
    def mean(self) -> float:
        return self._mean if self.n else math.nan

    @property
    def minimum(self) -> float:
        return self._min if self.n else math.nan

    @property
    def maximum(self) -> float:
        return self._max if self.n else math.nan

    @property
    def std(self) -> float:
        """Sample standard deviation (n-1 denominator); 0.0 for n == 1."""
        if self.n == 0:
            return math.nan
        if self.n == 1:
            return 0.0
        return math.sqrt(self._m2 / (self.n - 1))


def java_double(x: float) -> str:
    """Format a float the way Java's ``Double.toString`` does."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    a = abs(x)
    if 1e-3 <= a < 1e7:
        # repr gives the shortest round-trip decimal, like Java; it never
        # uses exponent form in this range, and integral floats get ".0"
        s = repr(x)
        if "e" in s or "E" in s:
            # repr switched to scientific inside Java's plain range
            # (only possible near the boundaries); expand it
            s = format(x, ".17g")
        return s
    # Java scientific: one digit before the point, 'E', no '+'
    s = repr(x)
    if "e" not in s and "E" not in s:
        s = format(x, "e")
    mant, _, exp = s.partition("e")
    exp_i = int(exp)
    mant_f = float(mant)
    # normalize mantissa to shortest round-trip at this exponent
    mant_s = repr(float(mant_f))
    if "." not in mant_s:
        mant_s += ".0"
    return f"{mant_s}E{exp_i}"
