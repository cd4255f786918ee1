"""Per-query predicate filters: the queries recommenders actually send.

The port's own copy of ``repro/serving/filters.py`` (numpy only, no import
of the reference).  The serving index turns a filter into the fused
kernel's bit-packed bitmap (``serving/index.py::_allowed_bitmap``).

Real retrieval traffic is never bare top-k — it is "top-k the user hasn't
seen, inside their tenant's namespace, restricted to an allowed catalog"
(DESIGN.md §17).  A ``QueryFilter`` names the three predicate families the
serving stack understands:

* **tenant** — namespace isolation.  Every indexed row carries an int32
  tenant tag (default 0); a query with tenant ``t`` can only ever surface
  rows tagged ``t``.  This is an *invariant*, not a ranking preference: the
  mask is applied inside the scorers, so a cross-tenant row cannot enter
  the candidate set on any path.
* **allowed_ids** — a shared (batch-wide) allow-list of external ids, the
  "in stock / in region" predicate.  Rows outside it are disallowed.
* **exclude_ids** — per-query exclusion lists ("already seen"), [m, E]
  int32 external ids, -1 padded.  Applied to the merged candidate set by
  external id; the fetch width is widened by E so exactness survives.

``mode`` picks the execution strategy (DESIGN.md §17): ``"pre"`` masks
disallowed rows to +inf inside the scan (exact, pays a bitmap operand),
``"post"`` scans unfiltered and drops disallowed candidates afterwards at a
selectivity-widened fetch width (cheap for near-trivial filters, lossy if
the widening budget is exhausted), and ``"auto"`` — the default — measures
the filter's live selectivity and picks: selective filters pre-filter,
permissive ones post-filter.

A ``None`` filter (or one with no predicates) takes the exact code path
that existed before filters did — bit-identical by construction, pinned by
tests/test_filters.py.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

MODES = ("auto", "pre", "post")

# "auto" pre-filters below this live-selectivity threshold.  At s = 0.5 the
# post-mode widening is only 2x — cheaper than a [m, n] mask operand for
# large n — while s « 0.5 widens the fetch toward the corpus size and the
# scan-side mask wins (DESIGN.md §17).
AUTO_PRE_BELOW = 0.5

# Post-mode overfetch widening is clamped to this factor: a 1e-3-selective
# filter must degrade to "probably incomplete" rather than compile a fetch
# width spanning the corpus.  "auto" never hits the clamp (it pre-filters
# first); explicit mode="post" owns the recall risk.
MAX_WIDEN = 64


class QueryFilter(NamedTuple):
    """Predicates for one search batch; see module docstring.

    ``tenant``: None (no namespace constraint), a scalar int (whole batch),
    or [m] ints (per query).  ``allowed_ids``: None or a 1-D array of
    external ids shared by the batch.  ``exclude_ids``: None, a single list
    of ids (whole batch), or a ragged/rectangular per-query list; -1 pads.
    ``mode``: "auto" | "pre" | "post".
    """

    tenant: object = None
    allowed_ids: object = None
    exclude_ids: object = None
    mode: str = "auto"


def normalize(f: QueryFilter | None, m: int) -> QueryFilter | None:
    """Canonicalize to numpy (or return None when there is nothing to do).

    Returns None for a trivially-true filter — the caller then takes the
    pre-filters code path verbatim (the bit-identity escape hatch).  A
    canonical filter has: tenant None or int32 [m]; allowed_ids None or
    sorted unique int32 [A]; exclude_ids None or int32 [m, E] -1-padded
    with E >= 1; mode validated.
    """
    if f is None:
        return None
    if f.mode not in MODES:
        raise ValueError(f"filter mode {f.mode!r} not in {MODES}")
    tenant = f.tenant
    if tenant is not None:
        tenant = np.asarray(tenant, np.int32)
        if tenant.ndim == 0:
            tenant = np.broadcast_to(tenant, (m,)).copy()
        assert tenant.shape == (m,), (tenant.shape, m)
    allowed = f.allowed_ids
    if allowed is not None:
        allowed = np.asarray(allowed, np.int64)
        if allowed.ndim != 1 or not (allowed[1:] > allowed[:-1]).all():
            allowed = np.unique(allowed)  # (a sorted, unique list is kept: no second sort)
        allowed = allowed.astype(np.int32)
    exclude = _pack_exclusions(f.exclude_ids, m)
    if tenant is None and allowed is None and exclude is None:
        return None
    return QueryFilter(tenant, allowed, exclude, f.mode)


def _pack_exclusions(exclude, m: int):
    """Ragged / scalar-row exclusion input -> rectangular [m, E] int32, -1 pad."""
    if exclude is None:
        return None
    if isinstance(exclude, np.ndarray) and exclude.ndim == 2:
        rows = [r[r >= 0] for r in exclude.astype(np.int64)]
    else:
        rows = [np.asarray(r, np.int64).ravel() for r in exclude]
        if len(rows) == 1 and m > 1:  # one shared list, broadcast
            rows = rows * m
    assert len(rows) == m, (len(rows), m)
    E = max((len(r) for r in rows), default=0)
    if E == 0:
        return None
    out = np.full((m, E), -1, np.int32)
    for i, r in enumerate(rows):
        assert (r >= 0).all() and (r < 2**31).all(), "ids must fit int32"
        out[i, : len(r)] = r
    return out


def exclusion_width(f: QueryFilter | None) -> int:
    """E — how much the fetch width must widen for exclusion exactness."""
    return 0 if f is None or f.exclude_ids is None else f.exclude_ids.shape[1]


def slice_rows(f: QueryFilter | None, lo: int, hi: int):
    """The filter restricted to query rows [lo, hi) (engine chunking)."""
    if f is None:
        return None
    return QueryFilter(
        None if f.tenant is None else f.tenant[lo:hi],
        f.allowed_ids,
        None if f.exclude_ids is None else f.exclude_ids[lo:hi],
        f.mode)


def pad_rows(f: QueryFilter | None, m_pad: int):
    """The filter extended to ``m_pad`` query rows (engine pow2 padding).

    Pad rows get tenant 0 and no exclusions — their results are sliced off
    by the engine, so any value is correct; 0/-1 keep the arrays canonical.
    """
    if f is None:
        return None
    if f.tenant is None and f.exclude_ids is None:
        return f  # no per-row arrays (allow-list only): nothing to pad
    pad = m_pad - (f.tenant.shape[0] if f.tenant is not None
                   else f.exclude_ids.shape[0])
    if pad <= 0:
        return f
    return QueryFilter(
        None if f.tenant is None
        else np.pad(f.tenant, (0, pad)),
        f.allowed_ids,
        None if f.exclude_ids is None
        else np.pad(f.exclude_ids, ((0, pad), (0, 0)), constant_values=-1),
        f.mode)


def selectivity(f: QueryFilter, *, live, ids, tenants) -> float:
    """Fraction of LIVE rows the batch's most selective query may see.

    Exact, host-side, O(n) — the row predicates (tenant tag + allow-list
    membership) are cheap numpy ops and the count drives a *static* choice
    (pre vs post + fetch width), so estimating would buy nothing but
    shapes that change from batch to batch.  Exclusions are ignored: they
    are per-query O(E) terms handled by the additive k+E widening, not the
    multiplicative 1/s one (DESIGN.md §17).
    """
    live = np.asarray(live, bool)
    n_live = int(live.sum())
    if n_live == 0:
        return 1.0
    base = live
    if f.allowed_ids is not None:
        base = base & np.isin(np.asarray(ids), f.allowed_ids)
    if f.tenant is None:
        return int(base.sum()) / n_live
    counts = {int(t): int((base & (np.asarray(tenants) == t)).sum())
              for t in np.unique(f.tenant)}
    return min(counts.values()) / n_live


def resolve_mode(mode: str, s: float) -> str:
    """'auto' -> 'pre' | 'post' from live selectivity ``s``."""
    if mode != "auto":
        return mode
    return "pre" if s < AUTO_PRE_BELOW else "post"


def widen(k: int, s: float) -> int:
    """Post-mode fetch width: ~k/s survivors' worth of candidates, clamped."""
    return int(np.ceil(k / max(s, 1.0 / MAX_WIDEN)))
