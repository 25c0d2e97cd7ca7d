"""Per-site cost attribution: where the wall time and INT8 GEMMs go.

Port of :mod:`repro.obs.attrib`, priced by the H100.  The tuner
decides *per site* how many splits to spend; this module answers the
follow-up question — which sites are actually worth retuning.  It
joins three things the telemetry stream already records:

* ``site_decl`` events — the static facts (m, k, n, batch, mult,
  splits, dtype) of every offloaded site;
* ``site_exec`` counts — how often each site really executed (scan
  iterations and backward products each count);
* tracer spans — the measured wall time of the run's hot loop
  (``train_step`` / ``prefill`` / ``decode_tick`` spans).

and prices each site with :mod:`repro_torch.kernels.tile_model`: INT8
pair-GEMMs, INT8 tensor-core operations and the modeled device-memory
bytes (``traffic(...).total_v2`` at K1's plan tile) per execution.
Measured wall time is then *attributed* across sites in proportion to
their modeled bottleneck time, the two-resource roofline of one H100:
``max(2*m*k*n*pairs / int8_ops, bytes / hbm_bw)`` over
:class:`~repro_torch.kernels.tile_model.HopperParams` (the same bound
as PERF.md's kernel table) — giving rows like

    site scan0/dot1: 38% wall, 52% INT8 GEMMs, s=6 -> s=4 saves 40%

The demotion column is the actionable part: dropping a site's split
count by 2 removes ``pairs(s) - pairs(s-2)`` pair-GEMMs per execution,
and the row reports that saving against the whole run.

Entry points: :func:`attribution` (events -> ranked
:class:`AttribRow` list), :func:`publish` (rows -> registry gauges so
``/metrics`` scrapes carry the shares live), and
``python -m repro_torch.obs attrib <dir>`` in
:mod:`repro_torch.obs.cli`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["AttribRow", "attribution", "publish", "WALL_SPAN_NAMES"]

#: Span names that measure the hot loop.  When a run recorded any of
#: these, their total duration is the wall time attributed across
#: sites; otherwise every span counts (a bare offload microbenchmark).
WALL_SPAN_NAMES = ("train_step", "prefill", "decode", "decode_tick",
                   "step", "generate")

#: Demotion step suggested per site: splits drop by 2 (one accuracy
#: notch in the tuner's ladder), floored at 1.
_DEMOTE_BY = 2


@dataclasses.dataclass
class AttribRow:
    """One site's share of the run, modeled and measured.

    The field names are the reference's (the CLI reads them).  On the
    H100 ``mxu_cycles`` holds the modeled INT8 tensor-core *operations*
    of the whole run, ``2*m*k*n*pairs(s)`` per problem: Hopper's rate
    is per operation, not per cycle of a fixed-shape unit, and
    ``model_time_s`` divides them by ``HopperParams.int8_ops``.
    """

    site: str
    splits: int
    execs: float                  # measured site_exec count
    int8_gemms: float             # pairs(s) * batch * cplx * execs
    mxu_cycles: float             # INT8 operations, whole run
    hbm_bytes: float              # modeled (v2 traffic), whole run
    model_time_s: float           # roofline bottleneck time, whole run
    gemm_share: float             # fraction of all sites' INT8 GEMMs
    wall_share: float             # fraction of measured wall attributed
    wall_s: Optional[float]       # wall_share * measured wall (if any)
    demote_to: int                # suggested splits (s - 2, min 1)
    demote_save_gemms: float      # INT8 GEMMs saved by the demotion
    demote_save_frac: float       # saving / this site's INT8 GEMMs

    def suggestion(self) -> str:
        """The actionable one-liner the table's last column renders."""
        if self.demote_to >= self.splits or self.int8_gemms <= 0:
            return "-"
        return (f"s={self.splits} -> s={self.demote_to} saves "
                f"{self.demote_save_gemms:.3g} INT8 GEMMs "
                f"({100 * self.demote_save_frac:.0f}%)")


def _exec_counts(events: List[dict]) -> Dict[str, float]:
    """Per-site execution counts: the flushed ``site_exec`` counter
    snapshot when the run closed cleanly, else the first-execution
    ``site_exec`` records (a lower bound of 1 per live site)."""
    counts: Dict[str, float] = {}
    for ev in events:
        if (ev.get("type") == "metric" and ev.get("kind") == "counter"
                and ev.get("name") == "site_exec"):
            site = (ev.get("labels") or {}).get("site", "?")
            counts[site] = counts.get(site, 0.0) + float(
                ev.get("value", 0))
    if not counts:
        for ev in events:
            if ev.get("type") == "site_exec":
                site = ev.get("site", "?")
                counts[site] = counts.get(site, 0.0) + 1.0
    return counts


def _measured_wall_s(events: List[dict]) -> Optional[float]:
    """Total hot-loop wall seconds from span events (dur is in us)."""
    spans = [ev for ev in events if ev.get("type") == "span"]
    if not spans:
        return None
    hot = [s for s in spans if s.get("name") in WALL_SPAN_NAMES]
    use = hot or spans
    return sum(float(s.get("dur", 0.0)) for s in use) / 1e6


def attribution(events: List[dict], params=None) -> List[AttribRow]:
    """Rank a run's offloaded sites by attributed cost.

    ``events`` is one run's event list (``read_events`` /
    ``load_runs`` output); ``params`` a
    :class:`repro_torch.kernels.tile_model.HopperParams` (default: one
    H100 SXM at 700 W).  Sites that never executed still get a row
    (execs 0, zero shares) so the table shows the full plan; rows sort
    by attributed wall share, then modeled time, then name.

    A site's problems are ``batch * execs`` (x4 if complex): the
    ``site_exec`` count already holds every scan iteration, so the trip
    multiplicity ``mult`` is not multiplied in again, and over an
    N-step run the INT8 GEMMs sum to ``N * count_int8_gemms(sites)``.
    """
    # Imported here, not at module top: the reading side of obs (the
    # CLI over a directory of runs) needs no tensor library.
    from ..core.ozaki import num_pair_gemms
    from ..kernels.tile_model import DEFAULT_PARAMS, select_tiles

    params = params or DEFAULT_PARAMS
    execs = _exec_counts(events)
    wall_s = _measured_wall_s(events)

    rows: List[AttribRow] = []
    for ev in events:
        if ev.get("type") != "site_decl" or not ev.get("offloaded"):
            continue
        site = ev.get("site", "?")
        s = int(ev.get("splits") or 0)
        m, k, n = ev.get("m"), ev.get("k"), ev.get("n")
        if s < 1 or not all(isinstance(d, int) and d > 0
                            for d in (m, k, n)):
            continue
        # One site execution covers ``batch`` GEMM problems, x4 when
        # the GEMM is complex (the 4-real-product lowering).
        per_exec = max(int(ev.get("batch") or 1), 1)
        if str(ev.get("dtype", "")).startswith("complex"):
            per_exec *= 4
        n_exec = execs.get(site, 0.0)
        problems = per_exec * n_exec

        decision = select_tiles(m, k, n, s, params=params)
        pairs = num_pair_gemms(s)
        int8_gemms = pairs * problems
        ops = 2.0 * m * k * n * pairs * problems
        hbm = float(decision.traffic_model.total_v2 * problems)
        model_t = max(ops / params.int8_ops, hbm / params.hbm_bw)

        demote_to = max(s - _DEMOTE_BY, 1)
        save = (pairs - num_pair_gemms(demote_to)) * problems
        rows.append(AttribRow(
            site=site, splits=s, execs=n_exec, int8_gemms=int8_gemms,
            mxu_cycles=ops, hbm_bytes=hbm, model_time_s=model_t,
            gemm_share=0.0, wall_share=0.0, wall_s=None,
            demote_to=demote_to, demote_save_gemms=save,
            demote_save_frac=save / int8_gemms if int8_gemms else 0.0))

    total_gemms = sum(r.int8_gemms for r in rows)
    total_model = sum(r.model_time_s for r in rows)
    for r in rows:
        r.gemm_share = (r.int8_gemms / total_gemms
                        if total_gemms else 0.0)
        r.wall_share = (r.model_time_s / total_model
                        if total_model else 0.0)
        r.wall_s = (wall_s * r.wall_share
                    if wall_s is not None else None)
    rows.sort(key=lambda r: (-r.wall_share, -r.model_time_s, r.site))
    return rows


def publish(rows: List[AttribRow], registry) -> None:
    """Mirror the attribution as per-site gauges on a
    :class:`repro_torch.obs.Registry`, so a live ``/metrics`` scrape carries
    the shares without anyone running the CLI."""
    for r in rows:
        registry.gauge("attrib_wall_share", site=r.site).set(
            r.wall_share)
        registry.gauge("attrib_gemm_share", site=r.site).set(
            r.gemm_share)
        registry.gauge("attrib_int8_gemms", site=r.site).set(
            r.int8_gemms)
        registry.gauge("attrib_demote_save_gemms", site=r.site).set(
            r.demote_save_gemms)
