"""Byte accounting of the collectives of one recorded port call — the
telemetry front end of ``analysis.dataflow`` (twin of
``repro.telemetry.jaxpr_stats``; the name is the reference's, the walk is
over the ops, kernel calls and collectives a recorded eager run shows).

It keeps the measurement contract: the ``all_gather_stats`` dict, plus the
totals folded into the ``collective/all_gather/*`` counters of an active
recorder, so an accounted dispatch shows up in the same trace file as
everything else.
"""
from __future__ import annotations

from repro_torch.telemetry import recorder as _rec

__all__ = ["all_gather_stats"]


def all_gather_stats(fn, *args, mesh=None, **kwargs) -> dict:
    """Run ``fn`` once, recorded, and account every ``all_gather``'s moved
    bytes.

    Returns ``{"ops": [...], "operand_bytes": one rank's input bytes,
    "gathered_bytes": operand bytes x gather width (one rank's receive
    volume)}``.  With ``mesh``, adds ``"global_operand_bytes"``: operand
    bytes x mesh size — for an operand partitioned across the whole mesh
    (the ``sharded:*`` payload gathers) this is exactly the *global* packed
    mask + hi + lo payload, the Eq.-1/2 fraction of a dense gather, which
    the runtime counter ``dispatch/sharded/gathered_packed_bytes`` also
    counts.  (An operand *replicated* along a mesh axis, e.g. the row
    pattern's scale gather, is counted once per replica.)
    """
    from repro_torch.analysis.dataflow import collective_stats

    out = collective_stats(fn, *args, mesh=mesh, **kwargs)
    if _rec.enabled():
        _rec.inc("collective/all_gather/ops", len(out["ops"]))
        _rec.inc("collective/all_gather/operand_bytes", out["operand_bytes"])
        _rec.inc("collective/all_gather/gathered_bytes", out["gathered_bytes"])
        if mesh is not None:
            _rec.inc("collective/all_gather/global_operand_bytes",
                     out["global_operand_bytes"])
    return out
