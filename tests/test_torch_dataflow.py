"""The port's dataflow tracer, collective accounting, lane and draft proofs
(``repro_torch.analysis.dataflow`` / ``suite`` / ``recompile``) against the
reference on the CPU.

* the tracer: taints spread by storage, views inherit them, a freed
  buffer's taint never lands on a new tensor, one decode site per leaf;
* local dispatch, the cache codecs and the serving lanes come out clean, as
  the reference's do, and the seeded decode-before-gather gives the
  reference's rule ids;
* ``collective_stats`` / ``all_gather_stats`` of every ``sharded:*``
  variant on 4 gloo ranks (2 x 2) equal the reference's on an Auto-axis
  ``jax.sharding.Mesh`` of 4 host devices, and the global operand bytes
  of a dispatch equal its ``dispatch/sharded/gathered_packed_bytes``;
* the draft proof is clean for both modes, with the reference's declared
  draft bytes, and a seeded draft lowering that reads lo is flagged;
* the recompile lint flags exactly the serial prefill and the commit lane
  today, and a seeded lane whose shape follows the prompt length.
"""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis import dataflow, recompile, suite
from repro_torch.core.policy import StruMConfig
from repro_torch.engine import registry as reg
from repro_torch.engine.dispatch import dispatch
from repro_torch.models import sharding as shd

import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = StruMConfig(method="mip2q", w=16, p=0.5, L=5)


def _leaf(k=64, n=128, cfg=CFG, seed=0):
    from repro_torch.models.quantize import _pack_leaf
    g = torch.Generator().manual_seed(seed)
    return _pack_leaf(torch.randn((k, n), generator=g), cfg)


# ----------------------------------------------------------------- tracer --

def test_taints_follow_storage_and_views():
    leaf = _leaf()

    def fn(lf, x):
        hi = lf["hi"][:, :4]                       # a view: still the stored leaf
        y = hi.to(torch.float32).sum()             # a decode site
        return x * 2.0, y
    trace = dataflow.trace_dataflow(fn, leaf, torch.ones(3))
    (site, regions), = trace.decode_sites
    assert regions == {("0/0", "hi", 0)}
    assert trace.events[site].name == "aten._to_copy.default"
    assert not any(e.name == "aten.slice.Tensor" and i in
                   trace.read_regions.get(("0/0", "hi", 0), [])
                   for i, e in enumerate(trace.events))
    assert trace.out_taints[0].state == dataflow.DECODED


def test_freed_decoded_buffer_taints_no_new_tensor():
    """The allocator would hand a freed decoded buffer's address to the next
    tensor of its size; the trace holds every tensor it saw, so the new one
    comes out clean."""
    leaf = _leaf()

    def fn(lf, x):
        d = lf["hi"].to(torch.float32)
        addr = d.untyped_storage().data_ptr()
        del d
        fresh = torch.zeros(leaf["hi"].shape)
        return (fresh + x).sum(), addr != fresh.untyped_storage().data_ptr()
    trace = dataflow.trace_dataflow(fn, leaf, torch.ones(()))
    assert trace.out_taints[0] is None


def test_layers_of_a_stacked_leaf_are_separate_regions():
    from repro_torch.models.quantize import _pack_leaf
    stack = _pack_leaf(torch.randn(3, 64, 128), CFG)
    x = torch.randn(2, 64)

    def fn(lf, xx):
        return [dispatch({k: v[i] for k, v in lf.items()}, xx, strum=CFG)
                for i in range(3)]
    trace = dataflow.trace_dataflow(fn, stack, x)
    assert len(trace.decode_sites) == 3
    assert len({off for _, f, off in trace.region_sites() if f == "mask"}) == 3
    assert dataflow.verify(fn, stack, x, trace=trace).ok


def test_decoding_a_leaf_twice_is_flagged():
    leaf = _leaf()
    x = torch.randn(4, 64)
    rep = dataflow.verify(lambda lf, xx: dispatch(lf, xx, strum=CFG)
                          + dispatch(lf, xx, strum=CFG), leaf, x, location="twice")
    assert rep.by_rule("dataflow/decode-multiplicity") and not rep.ok


def test_clean_scenarios_like_the_references():
    """Local dispatch, the sharded variants on a 1 x 1 mesh and the cache
    codecs: no finding, as ``tests/test_analysis.py`` requires of the
    reference's."""
    for rep in (suite.verify_local_apply(), suite.verify_sharded_variants(),
                suite.verify_cache_codecs()):
        assert rep.ok and not rep.findings, rep.render()


def test_seeded_dense_byte_gather():
    """Decode-before-gather: ``dataflow/fp-collective`` (error) plus the
    Eq.-1 byte mismatch, the reference's ids."""
    k = 64
    mesh = suite.OneDeviceMesh(("data",))
    leaf = _leaf(k)

    def dense_gather(lf, x):
        w = dispatch(lf, torch.eye(k), strum=CFG, backend="torch")   # decode FIRST
        w = shd.all_gather(w, mesh, "data", 0)
        return x @ w[:k]
    payload = sum(leaf[f].numel() for f in ("mask", "hi", "lo"))
    rep = dataflow.verify(dense_gather, leaf, torch.randn(4, k), location="seeded",
                          mesh=mesh, expected_payload_bytes=payload)
    assert rep.by_rule("dataflow/fp-collective") and rep.by_rule("dataflow/eq1-bytes")
    assert not rep.ok
    from repro import telemetry as jtel
    import jax.numpy as jnp
    assert jtel.all_gather_stats(lambda a: a * 2.0, jnp.zeros((4,))) == \
        dataflow.collective_stats(lambda a: a * 2.0, torch.zeros(4))


# ---------------------------------------------- collectives on 2 x 2 ranks --

REFERENCE = """
import functools, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.analysis.dataflow import collective_stats, verify
from repro.core.policy import StruMConfig
from repro.engine.registry import list_variants
from repro.models.quantize import _pack_leaf
from repro.models.sharding import shard_map

cfg = StruMConfig(method="mip2q", w=16, p=0.5, L=5)
mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
mesh1 = Mesh(np.array(jax.devices()[:2]), ("data",))
k, n = 128, 256
out, findings = {}, 0
for name, variant in sorted(list_variants().items()):
    if not variant.sharded:
        continue
    if variant.grouped:
        wleaf = _pack_leaf(np.zeros((2, k, n), np.float32), cfg)
        pay = P(None, ("data",), None, None)
        specs = {"mask": pay, "hi": pay, "lo": pay, "scale": P(None, None, None)}
        def run(lf, xg, _v=variant):
            return _v.fn(lf, xg, cfg=cfg, mesh=None, fsdp=("data",), pattern=None,
                         k_dim=k, backend="interpret", interpret=True,
                         accum_dtype=jnp.float32, out_dtype=jnp.float32)
        fn = shard_map(run, mesh=mesh1, in_specs=(specs, P(None, None, None)),
                       out_specs=P(None, None, None), check_vma=False)
        x = jnp.zeros((2, 4, k), jnp.float32)
        out[name] = collective_stats(fn, wleaf, x, mesh=mesh1)
        findings += len(verify(fn, wleaf, x, mesh=mesh1).findings)
        continue
    wleaf = _pack_leaf(np.zeros((k, n), np.float32), cfg)
    backend = "interpret" if variant.family == "pallas" else None
    for pattern in ("col", "row"):
        fn = functools.partial(variant.fn, cfg=cfg, mesh=mesh2, fsdp=("data",),
                               pattern=pattern, k_dim=k, backend=backend,
                               interpret=True, accum_dtype=jnp.float32,
                               out_dtype=jnp.float32)
        x = jnp.zeros((4, k), jnp.float32)
        out[f"{name}[{pattern}]"] = collective_stats(fn, wleaf, x, mesh=mesh2)
        findings += len(verify(fn, wleaf, x, mesh=mesh2).findings)
print("REF", json.dumps({"stats": out, "findings": findings}))
"""


@pytest.fixture(scope="module")
def two_by_two():
    """The reference subprocess on 4 forced host devices and the port's 4
    gloo ranks, run together."""
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}

    ref = ranks.reference_run(textwrap.dedent(REFERENCE), [], env, ROOT)
    port = ranks.spawn(ranks.dataflow_cases, 4, abort=ranks.reference_failed(ref))
    return json.loads(ranks.finish(ref).split("REF ", 1)[1]), port


def _jsonable(stats):
    """JSON-normal stats with each variant's ops as a sorted multiset (the
    reference's jaxpr orders a stack's gathers by its sorted field names)."""
    out = json.loads(json.dumps(stats, default=list))
    for st in out.values():
        st["ops"] = sorted(st["ops"], key=json.dumps)
    return out


def test_collective_stats_equal_the_references_for_every_sharded_variant(two_by_two):
    ref, port = two_by_two
    names = sorted(n for n, v in reg.list_variants().items() if v.sharded)
    assert {k.split("[")[0] for k in ref["stats"]} == set(names)
    assert ref["findings"] == 0
    for res in port:
        assert res["findings"]["counts"] == {"error": 0, "warning": 0, "info": 0}
        assert _jsonable(res["stats"]) == _jsonable(ref["stats"])


def test_all_gather_stats_equal_the_runtime_counter(two_by_two):
    """One sharded dispatch of a mesh-aware plan's leaf: the global operand
    bytes of its gathers are the global packed payload, and the same number
    as the runtime counter ``dispatch/sharded/gathered_packed_bytes``."""
    _, port = two_by_two
    for res in port:
        st, c, payload = res["dispatch_stats"], res["counters"], res["payload"]
        assert {o["dtype"] for o in st["ops"]} <= {"uint8", "int8", "float32"}
        packed = sum(o["operand_bytes"] for o in st["ops"] if o["dtype"] != "float32")
        assert packed * 4 == payload == c["dispatch/sharded/gathered_packed_bytes"]
        assert c["collective/all_gather/global_operand_bytes"] == st["global_operand_bytes"]
        assert payload == int(128 * 256 * CFG.compression_ratio)


# ------------------------------------------------------ lanes and drafts --

@pytest.fixture(scope="module")
def model():
    return suite.tiny_model()


def test_scheduler_lanes_and_fused_attention_clean(model):
    """The lanes record clean; under the cuda cache family the fused K4 is
    selected (the reference's ``cache:attn_fused`` under interpret) and its
    plain route reads exactly the pools' packed payload per step."""
    from repro.engine.cache import select_attn_variant as j_select
    from repro.core.policy import StruMConfig as JCfg
    cfg, params = model
    sched = suite.build_tiny_scheduler(cfg, params)
    rep = suite.verify_scheduler_lanes(sched)
    assert rep.ok and not rep.findings, rep.render()
    rep = suite.verify_fused_attention(model=model)
    assert rep.ok and not rep.findings, rep.render()
    for kv in (suite._KVCFG, suite._KVCFG_MIP):
        want = j_select(JCfg(method=kv.method, w=kv.w, p=kv.p, q=kv.q, L=kv.L),
                        page_size=kv.w, feat=cfg.n_kv_heads * cfg.hd,
                        backend="interpret").name
        fused = suite.build_tiny_scheduler(cfg, params, kv=kv, cache_backend="cuda")
        assert fused.spec.attn_variant == want == "cache:attn_fused"
        trace = dataflow.trace_dataflow(fused._decode, *suite.decode_lane_args(fused))
        assert trace.sealed_gather_packed_bytes() == suite.fused_read_bytes(fused) > 0
        assert len(trace.kernel_calls("cache:attn_fused")) == cfg.n_layers


def test_live_pages_follow_the_kernels_rule(model):
    """K4 reads a table entry when its page id is in the pool and its page
    slot is below the slot's sealed count: the tracer's count
    (``_live_pages``) and ``fused_read_bytes(lens=, table=)`` equal a count
    by hand on a table with holes, ids past the pool and partly sealed
    slots; without them ``fused_read_bytes`` is the table's capacity."""
    cfg, params = model
    sched = suite.build_tiny_scheduler(cfg, params, kv=suite._KVCFG, cache_backend="cuda")
    ns, pps, ps = sched.n_slots, sched.pages_per_seq, sched.spec.page_size
    pools = [p for p in sched.pools.values() if p]
    n_pools, n_pages = sum(p["k"]["mask"].shape[0] for p in pools), \
        pools[0]["k"]["mask"].shape[1]
    rng = np.random.default_rng(0)
    for _ in range(4):
        table = rng.integers(-1, n_pages + 2, size=(ns, pps)).astype(np.int32)
        lens = rng.integers(0, pps * ps + 1, size=ns)
        want = sum(1 for b in range(ns) for p in range(pps)
                   if 0 <= table[b, p] < n_pages and p < lens[b] // ps)
        assert dataflow._live_pages(torch.from_numpy(table), torch.from_numpy(lens // ps),
                                    n_pages) == want
        per_entry = suite.fused_read_bytes(sched) // (n_pools * 2 * ns * pps)
        assert suite.fused_read_bytes(sched, lens=lens, table=table) == \
            n_pools * 2 * want * per_entry
    assert dataflow._live_pages(torch.from_numpy(table), None, n_pages) == \
        int(((table >= 0) & (table < n_pages)).sum())


@pytest.mark.parametrize("mode", ["histream", "maskfree_p"])
def test_draft_payload_proof_clean_with_the_references_bytes(model, mode):
    from repro import engine as jengine
    from repro.core.policy import StruMConfig as JCfg
    from repro.engine import build_draft_plan as j_draft_plan
    from repro.engine import draft_plan_bytes as j_bytes
    from repro.engine.draft import DraftPolicy as JPolicy
    import _torch_f64_referee as referee
    from repro.models import model_defs as j_defs
    from repro.configs.base import get_smoke_config as j_smoke
    import dataclasses
    cfg, params = model
    sched = suite.build_tiny_scheduler(cfg, params, speculative=2, draft=mode)
    rep = suite.verify_draft_payload(sched, location=mode)
    assert rep.ok and not rep.findings, rep.render()
    poison = suite.draft_poison_check(sched)
    assert poison["bit_equal"] and poison["leaves"] == 7 * cfg.n_layers // cfg.n_layers
    jcfg = dataclasses.replace(j_smoke("qwen2_7b"), dtype="float32")
    jp = referee.jax_params(j_defs(jcfg), 0)
    jplan = jengine.build_plan(jp, cfg=JCfg(method="mip2q", w=16, p=0.5, L=5),
                               float_only=True)
    want = j_bytes(j_draft_plan(jplan, JPolicy(mode=mode)))
    from repro_torch.engine import draft_plan_bytes
    got = draft_plan_bytes(sched.draft_plan)
    assert (got["draft_bytes"], got["full_bytes"]) == (want["draft_bytes"],
                                                        want["full_bytes"])


def test_seeded_draft_lowering_that_reads_lo_is_flagged(model):
    """A histream lowering that dequantizes the whole payload (lo too):
    ``draft/stream-read`` on every drafted leaf, and the bytes no longer
    the declared ones."""
    from repro_torch.core import packing
    cfg, params = model
    name = "draft:torch_histream"
    saved = reg.get_variant(name)

    def reads_lo(x2, packed, *, out_dtype=None):
        return (x2 @ packing.dequantize(packed, x2.dtype)).to(out_dtype or x2.dtype)
    try:
        reg.register_kernel(name, family="torch", priority=0, draft=True,
                            supports=saved.supports)(reads_lo)
        sched = suite.build_tiny_scheduler(cfg, params, speculative=2, draft="histream")
        rep = suite.verify_draft_payload(sched, location="seeded")
    finally:
        reg._REGISTRY[name] = saved
    hits = rep.by_rule("draft/stream-read")
    assert len(hits) == 7 and all(f.location.endswith("/lo") for f in hits)
    assert rep.by_rule("draft/no-subset")


def test_recompile_lint_flags_exactly_the_lanes_that_follow_the_request(model):
    """Today the chunked lanes, decode, seal, draft and verify hold one
    signature; the serial prefill follows the prompt's length and the
    commit the accepted rows (ROADMAP perf item 1)."""
    cfg, params = model
    flagged, counts = [], {}
    for label, kw in (("scheduler", {}), ("serial", {"prefill": "serial"}),
                      ("spec", {"speculative": 2})):
        sched = suite.build_tiny_scheduler(cfg, params, **kw)
        rep = recompile.lint_scheduler_recompiles(sched=sched, location=label)
        flagged += [f.location for f in rep.findings]
        counts[label] = recompile.lane_trace_counts(sched)
    assert sorted(flagged) == ["serial/serial_prefill", "spec/commit"]
    assert counts["scheduler"] == {"decode": 1, "chunk_prefill": 1, "seal": 1}
    assert counts["spec"]["draft_decode"] == counts["spec"]["verify"] == 1


def test_seeded_prompt_length_lane_is_flagged(model):
    cfg, params = model
    sched = suite.build_tiny_scheduler(cfg, params)
    lane = sched._chunk_prefill

    def ragged(params_, tokens, pools, hot, table, slot, start, valid):
        torch.zeros(int(valid)).sum()          # a shape that follows the prompt
        return lane(params_, tokens, pools, hot, table, slot, start, valid)
    sched._chunk_prefill = ragged
    rep = recompile.lint_scheduler_recompiles(sched=sched, location="seeded")
    assert [f.location for f in rep.findings] == ["seeded/chunk_prefill"]
