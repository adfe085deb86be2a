"""``repro_torch.engine``: kernel registry, execution plans and the dispatch
funnel (twin of the single-device half of ``repro.engine``).

    plan = engine.build_plan(params, cfg=StruMConfig(), device="cuda")
    plan = engine.build_plan(params, schedule=sched)     # per-tensor configs
    y = engine.apply(plan, "blocks/pos0/mlp/wi/w", x)   # 2-D entries
    served = plan.params                                # model-shaped tree
    fq = engine.fake_quantize(params, schedule=sched)   # no bit-packing

KV-cache page codecs and the consumers of the page pools are registry
entries too (the ``cache:*`` family, :mod:`repro_torch.engine.cache`):
``build_cache_spec`` selects them per (codec, page geometry, device).
``build_draft_plan`` derives a plan's reduced-fidelity twin over the same
payload tensors (the ``draft:*`` partition, :mod:`repro_torch.engine.draft`).
``build_plan(mesh=...)`` records per-leaf layouts (:class:`ShardSpec`) and
selects from the ``sharded:*`` family (:mod:`repro_torch.engine.sharded`),
which all-gathers packed payloads before the kernel.
"""
from repro_torch.engine.cache import (CacheSpec, build_cache_spec,
                                      decode_pages, encode_page,
                                      gather_decode_pages,
                                      select_cache_variant)
from repro_torch.engine.draft import (DRAFT_MODES, DraftPolicy,
                                      build_draft_plan, draft_dequant_leaf,
                                      draft_dequant_packed, draft_leaf_bytes,
                                      draft_plan_bytes)
from repro_torch.engine.dispatch import (apply, dequant_leaf, dispatch,
                                         dispatch_grouped, leaf_spec)
from repro_torch.engine.plan import (ExecutionPlan, PlanEntry, build_plan,
                                     fake_quantize)
from repro_torch.engine.registry import (BACKENDS, ExecSpec, KernelVariant,
                                         LeafInfo, ShardSpec, get_variant,
                                         list_variants, register_kernel,
                                         resolve_backend, select_variant,
                                         unregister_kernel)
from repro_torch.engine.sharded import (dense_gather_bytes,
                                        gather_dequant_leaf, tp_pattern_for)

__all__ = ["CacheSpec", "build_cache_spec", "decode_pages", "encode_page",
           "gather_decode_pages", "select_cache_variant", "DRAFT_MODES",
           "DraftPolicy", "build_draft_plan", "draft_dequant_leaf",
           "draft_dequant_packed", "draft_leaf_bytes", "draft_plan_bytes",
           "apply", "dispatch",
           "dispatch_grouped", "dequant_leaf", "leaf_spec", "ExecutionPlan",
           "PlanEntry", "build_plan", "fake_quantize", "BACKENDS", "ExecSpec",
           "KernelVariant", "LeafInfo", "ShardSpec", "dense_gather_bytes",
           "gather_dequant_leaf", "tp_pattern_for", "get_variant", "list_variants",
           "register_kernel", "resolve_backend", "select_variant",
           "unregister_kernel"]
