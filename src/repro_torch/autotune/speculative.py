"""Acceptance-rate-aware draft-schedule search for self-speculative
decoding (twin of ``repro.autotune.speculative``).

A draft schedule is a :class:`repro_torch.engine.DraftPolicy` (which
reduced decode each leaf runs) plus a draft length ``k``.  Both trade
the draft lane's weight-byte read ratio ``c`` (``draft_plan_bytes``)
against the acceptance ``α``, which falls as the draft's output error
grows.  Per drafted leaf the error is the measured mean-square difference
between the full and the draft decode of the same packed payload, relative
to the leaf's signal power and scaled by its output noise gain; acceptance
is a monotone map of the sum (only the ordering across schedules is
contractual).  The expected speedup of greedy speculative decoding at
acceptance ``α``, draft length ``k`` and relative draft cost ``c``::

    E[tokens/round] = (1 - α^(k+1)) / (1 - α)        (k+1 when α = 1)
    cost/round      = k·c + 1                         (k drafts + 1 verify)
    speedup         = E[tokens/round] / (k·c + 1)

Gains are uniform unless the caller passes ``gains=`` or a forward
(``fn=``), from which the static numerics pass derives them
(``analysis.numerics.output_gains``).
"""
from __future__ import annotations

import torch

from repro_torch.engine.draft import (DraftPolicy, _map_packed,
                                      build_draft_plan, draft_dequant_leaf,
                                      draft_plan_bytes)

__all__ = ["draft_error_profile", "predicted_acceptance", "expected_speedup",
           "search_draft_schedule"]


def draft_error_profile(plan, policy: DraftPolicy, gains=None) -> dict:
    """Predicted draft output-error power for one policy.

    Per drafted leaf: ``gain(name) * mean((W_full - W_draft)^2) /
    mean(W_full^2)`` over the plan's actual packed payload, decoded on its
    device.  Leaves the policy keeps at full fidelity (or that no draft
    variant expresses) contribute exactly 0.
    """
    dplan = build_draft_plan(plan, policy)
    modes = dplan.meta["draft"]
    per_leaf: dict = {}

    def visit(name, leaf):
        mode = modes.get(name, "")
        if mode:
            wf = draft_dequant_leaf(leaf, "")
            wd = draft_dequant_leaf(leaf, mode)
            g = float(gains.get(name, 1.0)) if gains else 1.0
            sig = float(torch.mean(wf ** 2)) or 1.0
            per_leaf[name] = g * float(torch.mean((wf - wd) ** 2)) / sig
        return leaf

    _map_packed(visit, plan.params)
    return {"total_err2": float(sum(per_leaf.values())),
            "per_leaf": per_leaf, "modes": modes,
            **draft_plan_bytes(dplan)}


def predicted_acceptance(total_err2: float) -> float:
    """Monotone-decreasing map err2 -> α ∈ (0, 1].  Only the ordering
    across schedules is contractual (see module docstring)."""
    return 1.0 / (1.0 + float(total_err2))


def expected_speedup(alpha: float, k: int, c: float) -> float:
    """Tokens-per-cost ratio of (k drafts @ cost c + 1 verify) vs plain
    decode, at per-token acceptance ``alpha``."""
    alpha = min(max(float(alpha), 0.0), 1.0)
    if alpha >= 1.0 - 1e-12:
        expected = k + 1.0
    else:
        expected = (1.0 - alpha ** (k + 1)) / (1.0 - alpha)
    return expected / (k * c + 1.0)


def _label(policy: DraftPolicy) -> str:
    if not policy.overrides:
        return policy.mode
    ov = ",".join(f"{pat}={m or 'full'}" for pat, m in policy.overrides)
    return f"{policy.mode}[{ov}]"


def search_draft_schedule(plan, *, policies=None, ks=(1, 2, 3, 4),
                          gains=None, fn=None, fn_args=(), **fn_kwargs):
    """Pick ``(DraftPolicy, k)`` by predicted speculative speedup.

    ``gains`` maps leaf name -> output noise gain; pass the model forward
    as ``fn(params, *fn_args, **fn_kwargs)`` to compute them with
    :func:`repro_torch.analysis.numerics.output_gains` (what
    ``output_error_profile`` uses), or omit both for uniform gains.
    Returns ``{"rows", "profiles", "best"}`` where ``best`` carries the
    winning ``policy`` object, ``k``, and its predicted α / c / speedup.
    """
    if policies is None:
        policies = (DraftPolicy(mode="histream"),
                    DraftPolicy(mode="maskfree_p"))
    if gains is None and fn is not None:
        from repro_torch.analysis import numerics
        names = tuple(sorted(plan.entries))
        gains = numerics.output_gains(fn, plan.params, *fn_args, names=names,
                                      location="autotune.draft_schedule",
                                      **fn_kwargs)
    rows, profiles = [], {}
    best = None
    for policy in policies:
        prof = draft_error_profile(plan, policy, gains=gains)
        label = _label(policy)
        profiles[label] = prof
        alpha = predicted_acceptance(prof["total_err2"])
        for k in ks:
            sp = expected_speedup(alpha, k, prof["ratio"])
            row = {"policy": label, "k": int(k), "alpha_pred": alpha,
                   "cost_ratio": prof["ratio"], "err2": prof["total_err2"],
                   "speedup_pred": sp}
            rows.append(row)
            if best is None or sp > best["speedup_pred"]:
                best = dict(row, policy=policy)
    return {"rows": rows, "profiles": profiles, "best": best}
