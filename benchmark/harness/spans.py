"""Per-layer readings from the program's own spans
(``segsplat_tpu_torch.utils.profiling``). A span records only while a torch
profiler records, so in a run its records are those of the traced
sub-window; each reading is a sum over them divided by the traced
iterations. Where the run has no trace, or the program keeps no records or
none of the name, a reading is None."""

from __future__ import annotations

from typing import Optional


def _records() -> list:
    try:
        from segsplat_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "records", None)
    return list(read()) if callable(read) else []


def _iterations(ctx) -> Optional[int]:
    tr = ctx.get("trace")
    return tr.get("iterations") if tr else None


def self_ms(ctx, name: str) -> Optional[float]:
    """The span ``name``'s self time (its time less its enclosed spans'), ms
    a traced iteration."""
    n = _iterations(ctx)
    recs = [r for r in _records() if r.name == name] if n else []
    if not recs:
        return None
    return sum(r.self_ns for r in recs) * 1e-6 / n


def count(ctx, name: str, key: str) -> Optional[float]:
    """The span ``name``'s count ``key``, summed, a traced iteration."""
    n = _iterations(ctx)
    vals = [r.counts[key] for r in _records() if r.name == name and key in r.counts] if n else []
    if not vals:
        return None
    return sum(vals) / n
