"""Per-step INT8 GEMM volume of a site list.

Port of ``count_int8_gemms`` from :mod:`repro.tune.solve`; the solver
itself waits for ROADMAP item 7.
"""

from __future__ import annotations

from typing import Iterable

from ..core.intercept import Site
from ..core.ozaki import num_pair_gemms

__all__ = ["count_int8_gemms"]


def count_int8_gemms(sites: Iterable[Site], splits_for=None) -> int:
    """Per-step INT8 GEMM count of a site-decision list.

    Sums, over offloaded sites, the Ozaki pair count ``s(s+1)/2`` times
    the batch extent, the trip multiplicity (enclosing ``scan``
    lengths), and 4 for complex sites (the four-real-GEMM
    decomposition).  ``splits_for(site) -> int | None`` overrides each
    site's recorded split count (``None``: the site runs native and
    counts 0).
    """
    total = 0
    for site in sites:
        if not site.offloaded:
            continue
        s = site.splits if splits_for is None else splits_for(site)
        if s is None:
            continue
        cplx = 4 if site.dtype.is_complex else 1
        total += (num_pair_gemms(s) * max(site.batch, 1)
                  * site.mult * cplx)
    return total
