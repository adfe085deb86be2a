"""The dry-run on one rank of a production mesh: the collective stand-in of
an abstract mesh against live gloo ranks and against the reference's HLO.

* the stand-in against live ranks: ``launch.dryrun.count_step`` on an
  ``AbstractMesh`` (``meta`` tensors, no process group, the CPU's kernel
  choices) records, collective by collective and in order, what the same
  step records on rank 0 of 4 real gloo ranks under the same ``Counter``
  (``tests/_torch_ranks.py``): primitive, kind, result shape and dtype,
  group width and bytes, and the kernel calls.  Decode and prefill on
  2 x 2, decode on 2 x 1 x 2 ("pod", "data", "model") and a train step
  on data = 2 and on 2 x 2; the OLMo and Moonshot smoke configs, packed with the
  default ``StruMConfig``.  On CPU tensors the card's plan runs its
  post-gather products on the ``torch`` family, so no kernel is called
  there (``chip_smoke.py`` phase v3 holds the K1 calls on the card);
* against the reference: its packed decode of the same smoke configs on a
  2 x 2 Auto-axis ``jax.sharding.Mesh`` of 4 forced host devices, layers
  unrolled, compiled; the s8 / u8 all-gathers of its HLO (the packed
  payload gathers, by ``repro.launch.dryrun``'s own pattern) are the
  port's int8 / uint8 all-gathers, shape for shape and count for count;
* the ring model: ``collective_bytes`` of the port over hand-written
  collectives equals the reference's over the same collectives as HLO;
* the stand-in refuses: an abstract mesh with a CPU tensor raises in
  ``all_gather``, ``all_reduce`` and ``count_step``; a mesh that is not
  abstract never takes the stand-in;
* the CLI and the example: ``--both-meshes`` writes one record per mesh with the
  reference's keys, ``long_500k`` of a full-attention arch is skipped on
  both; ``--attn-constraint`` counts what the baseline counts, and so
  does ``--accum-dtype`` in collectives and kernel calls;
* the layouts: the serving cells of OLMo and Moonshot are counted in the
  sharded serving layout (no ``out_gather``; a 2x16x16 decode_32k's rank 0
  holds and computes under 1/256 of one H100's cell); every train step in
  the train layout on data = 2 and on 2 x 2, forward and backward (no
  all-gather gives a whole parameter), OLMo's and Moonshot's alike.
"""
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import sharding as shd

import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(case, arch) for case, *_ in ranks.MESH_CASES for arch in ranks.MESH_ARCHS]

#: the ring model's input, as partitioned HLO
RING_HLO = """
  %ag = u8[4,2,32]{2,1,0} all-gather(u8[2,2,32]{2,1,0} %p0), dimensions={0}
  %ar = f32[2,1,64]{2,1,0} all-reduce(f32[2,1,64]{2,1,0} %p1), to_apply=%add
  %rs = bf16[8,16]{1,0} reduce-scatter(bf16[16,16]{1,0} %p2), dimensions={0}
  %a2a = s8[4,4]{1,0} all-to-all(s8[4,4]{1,0} %p3), dimensions={0}
  %cp = f32[3]{0} collective-permute(f32[3]{0} %p4), source_target_pairs={{0,1}}
  %ag2 = bf16[16,64]{1,0} all-gather(bf16[8,64]{1,0} %p5), dimensions={0}
"""
#: the same collectives as the port's Counter records them
RING_RECORDS = [{"kind": "all-gather", "bytes": 4 * 2 * 32},
                {"kind": "all-reduce", "bytes": 2 * 64 * 4},
                {"kind": "reduce-scatter", "bytes": 8 * 16 * 2},
                {"kind": "all-to-all", "bytes": 16},
                {"kind": "collective-permute", "bytes": 12},
                {"kind": "all-gather", "bytes": 16 * 64 * 2}]

REFERENCE = """
import dataclasses, json, sys
import jax, numpy as np
jax.devices()   # the 4 forced host devices, before repro.launch.dryrun adds its flags
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.core.policy import StruMConfig
from repro.launch.dryrun import _COLL_RE, collective_bytes
from repro.launch.specs import input_shardings, input_specs
from repro.launch.steps import make_decode_step
from repro.models.sharding import rules_for_mesh

ring, archs = sys.argv[1], sys.argv[2:]
out = {"ring": collective_bytes(ring)}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
shape = ShapeSpec("decode_small", 16, 4, "decode")
for arch in archs:
    cfg = dataclasses.replace(get_smoke_config(arch), strum=StruMConfig(),
                              scan_layers=False)
    rules = rules_for_mesh(mesh, shape.global_batch)
    with mesh:
        hlo = jax.jit(make_decode_step(cfg, mesh=mesh, rules=rules),
                      in_shardings=input_shardings(cfg, shape, mesh, rules)
                      ).lower(*input_specs(cfg, shape)).compile().as_text()
    out[arch] = {"coll": collective_bytes(hlo),
                 "packed": [[m.group(1), m.group(2)] for m in _COLL_RE.finditer(hlo)
                            if m.group(3) == "all-gather"
                            and m.group(1) in ("s8", "u8")]}
print("META", json.dumps(out))
"""


@pytest.fixture(scope="module")
def run():
    """Rank 0's live counts of every case, and the reference's HLO counts,
    the two run side by side."""
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    ref = ranks.reference_run(textwrap.dedent(REFERENCE),
                              [RING_HLO, *ranks.MESH_ARCHS], env, ROOT)
    live = ranks.spawn(ranks.mesh_dryrun_cases, 4, abort=ranks.reference_failed(ref))
    return live[0], json.loads(ranks.finish(ref).split("META ", 1)[1])


def _abstract(case: str, target: str = "cpu") -> tuple:
    shape, names, kind = next((s, n, k) for c, s, n, k in ranks.MESH_CASES if c == case)
    return AbstractMesh(shape, names, target=target), ranks.mesh_shape_spec(kind)


def _records(cfg, shape, mesh) -> tuple:
    """``count_step``'s collective records and counts, on f32 weights (the
    live ranks' dtype: packed scales are f32 as ``build_plan`` stores
    them, where the default specs' bf16 override makes them bf16)."""
    counts = dryrun.count_step(cfg, shape, dryrun.input_specs(cfg, shape,
                                                              param_dtype="float32"),
                               mesh=mesh)
    return counts.pop("collective_records"), counts


@pytest.mark.parametrize("case,arch", CASES, ids=[f"{c}-{a}" for c, a in CASES])
def test_abstract_count_equals_live_ranks(run, case, arch):
    live = run[0][(case, arch)]
    mesh, shape = _abstract(case)
    recs, counts = _records(ranks.mesh_cfg(arch), shape, mesh)
    assert recs == live["collectives"]
    assert counts["kernels"] == live["kernels"]
    want = dryrun.collective_bytes(live["collectives"])
    assert {k: counts["collectives"][k] for k in want} == want
    assert "out_gather_bytes" not in counts["collectives"]
    kinds = {r["primitive"] for r in recs}
    assert {"all_gather", "psum"} <= kinds
    # every serving cell runs the sharded serving layout, which keeps every
    # result at its spec (no re-assembly to global); every train step the
    # train layout, which gathers no parameter whole
    layout = dryrun.layout_of(ranks.mesh_cfg(arch), shape.kind, mesh)
    assert layout == ("tp_train" if shape.kind == "train" else "input_shardings")
    assert "out_gather" not in kinds
    if layout == "tp_train":
        from repro_torch.models import model_defs
        from repro_torch.models.params import _with_defs
        whole = set()
        _with_defs(lambda _, d: whole.add(tuple(d.shape)), model_defs(
            ranks.mesh_cfg(arch)), model_defs(ranks.mesh_cfg(arch)))
        gathered = {r["shape"] for r in recs if r["primitive"] == "all_gather"}
        assert gathered and not gathered & {s for s in whole if len(s) >= 2}


@pytest.mark.parametrize("arch", ranks.MESH_ARCHS)
def test_packed_gathers_match_the_references_hlo(run, arch):
    """The reference gathers the packed payloads with ``sharded:gather_dequant``
    on the CPU (XLA family) and the port's card plan with
    ``sharded:gather_pallas``: the same fields of the same leaves."""
    ref = run[1][arch]
    mesh, shape = _abstract("decode_2x2", target="cuda")
    recs, _ = _records(ranks.mesh_cfg(arch), shape, mesh)
    names = {"torch.int8": "s8", "torch.uint8": "u8"}
    port = sorted([names[r["dtype"]], ",".join(map(str, r["shape"]))] for r in recs
                  if r["primitive"] == "all_gather" and r["dtype"] in names)
    assert port == sorted(ref["packed"]) and len(port) > 0
    size = lambda s: int(np.prod([int(d) for d in s.split(",")]))  # noqa: E731
    assert sum(size(s) for _, s in port) == sum(size(s) for _, s in ref["packed"])


def test_collective_bytes_is_the_references_ring_model(run):
    got = dryrun.collective_bytes(RING_RECORDS)
    assert got == run[1]["ring"]
    assert got["link_bytes"] == 2 * 512 + 256 + 256 + 16 + 12 + 2048


def test_the_stand_in_refuses_real_tensors():
    mesh = AbstractMesh((2, 2), ("data", "model"))
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="meta tensors only"):
        shd.all_gather(x, mesh, "data", 0)
    with pytest.raises(ValueError, match="meta tensors only"):
        shd.all_reduce(x, mesh, "model")
    with pytest.raises(ValueError, match="meta tensors only"):   # a group of one too
        shd.all_gather(x, AbstractMesh((1, 2), ("data", "model")), "data", 0)
    cfg, shape = ranks.mesh_cfg("olmo_1b"), ranks.mesh_shape_spec("decode")
    inputs = ranks._materialize(dryrun.input_specs(cfg, shape), torch.Generator())
    with pytest.raises(ValueError, match="meta inputs only"):
        dryrun.count_step(cfg, shape, inputs=inputs, mesh=mesh)
    # on meta: the result's shape, the coordinate the mesh was made with
    m = torch.empty(2, 3, device="meta")
    assert shd.all_gather(m, mesh, ("data", "model"), 1).shape == (2, 12)
    assert shd.all_reduce(m, mesh, "data", "mean").shape == (2, 3)
    at = AbstractMesh((2, 4), ("data", "model"), coord=(1, 3))
    assert shd.axis_index(at, ("data", "model")) == 7
    with pytest.raises(ValueError, match="not one of its ranks"):
        AbstractMesh((2, 2), ("data", "model"), coord=(2, 0))


def test_a_mesh_that_is_not_abstract_never_takes_the_stand_in():
    class Live:                   # a mesh-like object with no process groups
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 2

    with pytest.raises(AttributeError):
        shd.all_gather(torch.empty(2, 3, device="meta"), Live(), "data", 0)


def test_production_meshes_on_meta():
    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16), ("pod", "data", "model"))):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        assert isinstance(mesh, AbstractMesh) and mesh.target == "cuda"
        assert mesh.shape == shape and mesh.mesh_dim_names == names
        assert mesh.size() == int(np.prod(shape)) and mesh.device_type == "meta"
        assert shd.axis_sizes(mesh) == dict(zip(names, shape))
        assert shd.axis_index(mesh, names) == 0


def test_cli_both_meshes(tmp_path):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--both-meshes", "--arch", "olmo_1b", "--shape", "train_4k",
                        "--out", str(out)]) == 0
    assert dryrun.main(["--both-meshes", "--arch", "olmo_1b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "OK"), ("2x16x16", "OK"),
        ("16x16", "SKIP(full-attn)"), ("2x16x16", "SKIP(full-attn)")]
    one = dryrun.lower_cell("olmo_1b", "train_4k")
    keys = {"arch", "shape", "mesh", "variant", "status", "kind", "n_devices",
            "link_bytes_per_dev", "collectives", "memory", "roofline",
            "model_flops_total", "model_flops_per_dev", "useful_flops_ratio"}
    for rec, n in zip(recs, (256, 512)):
        assert keys <= set(rec) and rec["n_devices"] == n and "note" in rec
        coll = rec["collectives"]
        assert rec["link_bytes_per_dev"] == coll["link_bytes"] > 0
        assert coll["per_kind_count"]["all-gather"] > 0 and coll["per_kind_count"]["all-reduce"] > 0
        assert rec["roofline"]["collective_s"] == pytest.approx(coll["link_bytes"] / 50e9)
        # the dense decoders' train layout: the batch splits over the data
        # axes and the heads, the MLP and the vocabulary over "model", so
        # each card counts a 1/n of one card's step
        assert rec["layout"] == "tp_train"
        assert rec["flops_per_dev"] < one["flops_per_dev"]
        assert rec["model_flops_per_dev"] == pytest.approx(one["model_flops_total"] / n)
        assert rec["flops_per_dev"] == pytest.approx(one["flops_per_dev"] / n, rel=0.05)
    assert dryrun.roofline_terms(0.0, 0.0, 450e9, 8)["collective_s"] == pytest.approx(1.0)


def test_attn_constraint_counts_equal_the_baseline():
    """``cfg.attn_heads_constraint`` acts through the checked ``constrain``:
    it moves nothing, so every count is the baseline's."""
    import dataclasses
    mesh, shape = _abstract("prefill_2x2", target="cuda")
    cfg = ranks.mesh_cfg("olmo_1b")
    base = dryrun.count_step(cfg, shape, mesh=mesh)
    con = dryrun.count_step(dataclasses.replace(cfg, attn_heads_constraint=True), shape,
                            mesh=mesh)
    for rec in (base, con):
        rec.pop("seconds")
        rec.pop("collective_records")
    assert con == base and base["kernels"] and base["collectives"]["link_bytes"] > 0


def test_accum_dtype_leaves_the_cards_collectives():
    """``--accum-dtype bfloat16`` on the card's plan: the post-gather
    kernels ignore it and the partial sums stay f32 (the reference's
    ``gather_pallas`` sums ``out_dtype=f32`` too), so collectives and kernel
    calls are the baseline's; the dense products' rounding adds ATen work."""
    import dataclasses
    mesh, shape = _abstract("prefill_2x2", target="cuda")
    cfg = ranks.mesh_cfg("olmo_1b")
    base = dryrun.count_step(cfg, shape, mesh=mesh)
    acc = dryrun.count_step(dataclasses.replace(cfg, accum_dtype="bfloat16"), shape,
                            mesh=mesh)
    assert acc["collectives"] == base["collectives"]
    assert acc["kernels"] == base["kernels"] and acc["kernels"]
    dense = dataclasses.replace(cfg, strum=None, dtype="float32")
    d32 = dryrun.count_step(dense, shape)
    d16 = dryrun.count_step(dataclasses.replace(dense, accum_dtype="bfloat16"), shape)
    assert d16["aten_bytes"] > d32["aten_bytes"]


def test_dryrun_cell_multi_pod(capsys):
    from repro_torch.examples import dryrun_cell
    assert dryrun_cell.main(["--arch", "olmo_1b", "--shape", "decode_32k",
                             "--multi-pod"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 512 and rec["status"] == "OK"
    # the sharded serving layout: rank 0 holds 1/512 of the batch's work and
    # of the cache, and moves the FSDP gathers, the row all-reduces, the
    # vocab-parallel embedding and the flash-decode merge
    assert rec["layout"] == "input_shardings"
    assert rec["link_bytes_per_dev"] > 0
    one = dryrun.lower_cell("olmo_1b", "decode_32k")
    assert rec["flops_per_dev"] < one["flops_per_dev"] / 256
    assert rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"] / 256


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", ranks.MESH_ARCHS)
def test_mesh_extrapolation_equals_a_direct_count(arch, kind):
    """On a 2 x 2 abstract mesh, five periods counted directly and
    extrapolated from 1 and 2 periods (a train step from 2, 3 and 4):
    collectives, FLOPs, bytes and kernel calls equal exactly."""
    import dataclasses

    from repro_torch.configs.base import get_config, tiny_variant
    cfg = tiny_variant(get_config(arch))
    cfg = dataclasses.replace(cfg, n_layers=5 * dryrun.period(cfg),
                              strum=ranks.mesh_cfg(arch).strum)
    mesh, shape = AbstractMesh((2, 2), ("data", "model")), ranks.mesh_shape_spec(kind)
    got = dryrun.extrapolated_costs(cfg, shape, mesh)
    want = dryrun.count_step(cfg, shape, mesh=mesh)
    for k in ("collectives", "flops", "bytes", "kernels"):
        assert got[k] == want[k], k
    assert want["collectives"]["link_bytes"] > 0
