"""Static grid geometry.

Replaces the N1/N2/N3/L1/L2/L3/d1/d2/d3 scalar plumbing threaded through every
function of the reference (e.g. reference barlib/src/init_par.cc:216-222,
struct_hamil.h). A frozen dataclass is hashable, so it can key caches and be
closed over by the functions that use it.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Periodic box geometry: N cells per axis, physical size L (Mpc/h)."""

    N1: int
    N2: int
    N3: int
    L1: float
    L2: float
    L3: float

    @classmethod
    def cube(cls, N: int, L: float) -> "GridSpec":
        return cls(N, N, N, float(L), float(L), float(L))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.N1, self.N2, self.N3)

    @property
    def rshape(self) -> tuple[int, int, int]:
        """Shape of the half-complex (rfft) representation."""
        return (self.N1, self.N2, self.N3 // 2 + 1)

    @property
    def N(self) -> int:
        return self.N1 * self.N2 * self.N3

    @property
    def vol(self) -> float:
        return self.L1 * self.L2 * self.L3

    @property
    def cell(self) -> tuple[float, float, float]:
        return (self.L1 / self.N1, self.L2 / self.N2, self.L3 / self.N3)

    @property
    def cell_avg(self) -> float:
        d1, d2, d3 = self.cell
        return (d1 + d2 + d3) / 3.0

    @property
    def kmax(self) -> float:
        """|k| at the (N/2,N/2,N/2) corner — the reference's spectrum binning
        range (field_statistics.cpp:37-40)."""
        kx = math.pi * self.N1 / self.L1
        ky = math.pi * self.N2 / self.L2
        kz = math.pi * self.N3 / self.L3
        return math.sqrt(kx * kx + ky * ky + kz * kz)
