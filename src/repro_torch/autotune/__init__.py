"""repro_torch.autotune: hardware-cost-aware per-layer StruM schedule
search (twin of ``repro.autotune``), the compiler half of the paper's
dynamically configurable PE (Fig. 9): profile -> search -> schedule ->
plan -> serve.

    from repro_torch import engine
    from repro_torch.autotune import Budget, StruMSchedule, search_schedule

    sched = search_schedule(params, Budget(target_ratio=0.875))
    sched.save("sched.json")                      # the reference's JSON
    plan = engine.build_plan(params,
                             schedule=StruMSchedule.load("sched.json"))

Modules: ``costmodel`` (Fig.-13 area/power + Eq.-1/2 bytes), ``sensitivity``
(batched, content-hash-cached SQNR profiling on the tensors' device),
``search`` (Pareto frontiers + greedy Lagrangian allocator), ``schedule``
(the serializable ``StruMSchedule`` that lowers to ``LayerPolicy``),
``speculative`` (draft-schedule search).  ``output_error_profile`` and the
``fn=`` arms wait for the static numerics pass: they raise.
"""
from repro_torch.autotune.costmodel import CostEstimate, config_cost, level_savings
from repro_torch.autotune.schedule import (StruMSchedule, config_from_dict,
                                           config_key, config_to_dict)
from repro_torch.autotune.search import (Budget, Candidate, pareto_frontier,
                                         search_schedule)
from repro_torch.autotune.sensitivity import (DEFAULT_GRID, cache_info,
                                              clear_cache, int8_sqnr_db,
                                              output_error_profile,
                                              profile_array, profile_tree)
from repro_torch.autotune.speculative import (draft_error_profile,
                                              expected_speedup,
                                              predicted_acceptance,
                                              search_draft_schedule)

__all__ = [
    "CostEstimate", "config_cost", "level_savings",
    "StruMSchedule", "config_from_dict", "config_key", "config_to_dict",
    "Budget", "Candidate", "pareto_frontier", "search_schedule",
    "DEFAULT_GRID", "cache_info", "clear_cache", "int8_sqnr_db",
    "output_error_profile", "profile_array", "profile_tree",
    "draft_error_profile", "expected_speedup", "predicted_acceptance",
    "search_draft_schedule",
]
