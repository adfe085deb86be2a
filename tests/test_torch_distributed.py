"""The port's distributed execution against the JAX reference on the CPU, on
4 gloo ranks: a 2 x 2 ("data", "model") mesh, a ``pp`` = 4 pipeline, a
4 x 1 mesh for the elastic restore.

One module fixture runs everything once (``tests/_torch_ranks.py``): the
reference in one subprocess on 4 forced host devices over Auto-axis
``jax.sharding.Mesh`` meshes (jax 0.9's ``jax.make_mesh``, which the
reference's ``make_host_mesh`` calls, makes Explicit axes, which its
``constrain`` refuses: with Auto axes its sharded train step and packed
decode run), the port on 4 gloo ranks at the same time, both from the same
seeded inputs.  Held:

* ``gather_dequant_leaf`` (col and row) equals the fake-quant weight within
  1e-5 (``tests/test_gather_dequant.py``);
* the expert-parallel MoE body, dense and packed stacks, equals the
  single-device ``moe_apply`` and the reference's within 1e-4
  (``tests/test_distributed.py``, ``tests/test_grouped.py``);
* GPipe over pp = 4 equals the sequential stages within 1e-5;
* the train step on 2 x 2 (the train layout, ``make_train_step(mesh=)``;
  the ZeRO-3 step, ``steps._zero3_step``, for Qwen3-MoE smoke with tokens
  dropped): three steps equal the single-device ``make_train_step``'s,
  every parameter and moment within 1e-5 of its leaf's largest value
  (OLMo smoke and Qwen3-MoE smoke, f32), with gradient compression all
  but 0.1% of them and of the error-feedback residual; Qwen2's and
  Qwen3-MoE's smoke loss within 5e-3 of the reference's sharded step (as
  ``test_sharded_train_step_matches_single_device`` asks); Qwen3-MoE's
  train layout at capacity factor 1, f32, its first loss and aux within
  1e-4 relative of the reference's sharded step (each data rank routes
  its rows with its own capacity);
* the elastic round trip: a ZeRO-3 state saved from the 2 x 2 mesh
  restores bit for bit, and steps on data = 4 and on one device agree;
* a packed decode on 2 x 2 in the sharded serving layout (a mesh-aware
  plan, every input placed at the reference's ``input_shardings``, the
  logits gathered whole) within 2e-3 of the dense fake-quant decode and of
  the reference's, and a mesh-less plan's decode in the same layout equal
  to the mesh-aware plan's;
* ``sharding.constrain`` slices a whole tensor and re-lays a placed one
  out;
* ``BatchScheduler(mesh=)`` on the OLMo smoke config, teacher-forced, gives
  the single-device scheduler's tokens; ``serve --mesh 2x2`` the tokens of
  ``serve`` on one device.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import model_defs as j_model_defs
from repro.models.moe import moe_def as j_moe_def
from repro.models.params import init_params as j_init_params
from repro.runtime.elastic import plan_remesh as j_plan_remesh
from repro_torch.runtime.elastic import plan_remesh

import _torch_f64_referee as referee
import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import engine
from repro.configs import get_smoke_config
from repro.core.policy import StruMConfig, default_policy
from repro.launch.steps import make_train_step
from repro.models import model_defs, prefill, decode_step
from repro.models.moe import moe_apply
from repro.models.sharding import rules_for_mesh
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.runtime.pipeline import pipelined_apply

src, dst = sys.argv[1], sys.argv[2]
PAGED_ARCHS = sys.argv[3:]
data = dict(np.load(src))
J = lambda k: jnp.asarray(data[k])
def sub(prefix):
    tree = {}
    for name, v in data.items():
        if name.startswith(prefix + "/"):
            node = tree
            parts = name[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    return tree
out, meta = {}, {}
devs = np.array(jax.devices()[:4])
mesh = Mesh(devs.reshape(2, 2), ("data", "model"))
mcfg = get_smoke_config("qwen3_moe_235b_a22b")
with mesh:
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, mcfg, mesh=mesh))(
        sub("moe_params"), J("moe_x"))
    out["moe_dense"], meta["moe_dense_aux"] = np.asarray(y), float(aux)
    scfg = StruMConfig(method="mip2q", p=0.5, L=5, w=16)
    pcfg = dataclasses.replace(mcfg, strum=scfg)
    pk = engine.build_plan({"blocks": {"moe": sub("moe_params32")}},
                           cfg=scfg).params["blocks"]["moe"]
    y, aux = jax.jit(lambda p, x: moe_apply(p, x, pcfg, mesh=mesh))(pk, J("moe_x"))
    out["moe_packed"], meta["moe_packed_aux"] = np.asarray(y), float(aux)

pmesh = Mesh(devs.reshape(4, 1, 1), ("pp", "data", "model"))
with pmesh:
    out["pp"] = np.asarray(pipelined_apply(lambda w, x: jnp.tanh(x @ w), J("pp_ws"),
                                           J("pp_x"), mesh=pmesh, n_micro=4))

cfg = get_smoke_config("qwen2_7b")
params = sub("qwen_params")
batch = {"tokens": J("batch0_tokens"), "labels": J("batch0_labels")}
ocfg = AdamWConfig(lr=1e-3, total_steps=10)
_, _, m1 = jax.jit(make_train_step(cfg, ocfg))(params, init_opt_state(params), batch)
meta["train_loss_single"] = float(m1["loss"])
rules = rules_for_mesh(mesh)
with mesh:
    _, _, m2 = jax.jit(make_train_step(cfg, ocfg, mesh=mesh, rules=rules))(
        params, init_opt_state(params), batch)
meta["train_loss_sharded"] = float(m2["loss"])
qm = get_smoke_config("qwen3_moe_235b_a22b")
qmp = sub("qmoe_params")
_, _, m1 = jax.jit(make_train_step(qm, ocfg))(qmp, init_opt_state(qmp), batch)
with mesh:
    _, _, m2 = jax.jit(make_train_step(qm, ocfg, mesh=mesh, rules=rules))(
        qmp, init_opt_state(qmp), batch)
meta["train_moe_single"] = (float(m1["loss"]), float(m1["aux"]))
meta["train_moe_sharded"] = (float(m2["loss"]), float(m2["aux"]))
qc1 = dataclasses.replace(qm, dtype="float32", capacity_factor=1.0)
with mesh:
    _, _, m2 = jax.jit(make_train_step(qc1, ocfg, mesh=mesh, rules=rules))(
        qmp, init_opt_state(qmp), batch)
meta["train_moe_c1_sharded"] = (float(m2["loss"]), float(m2["aux"]))

dcfg = StruMConfig(method="mip2q", p=0.5, L=7)
base = dataclasses.replace(cfg, dtype="float32")
scfg_m = dataclasses.replace(base, strum=dcfg)
served = engine.build_plan(params, cfg=dcfg).params
fakeq = engine.fake_quantize(params, policy=default_policy(dcfg), baseline_int8=False)
_, caches = prefill(fakeq, {"tokens": jnp.ones((2, 8), jnp.int32)}, base)
caches = jax.tree.map(lambda x: jnp.pad(
    x, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]) if x.ndim == 5 else x, caches)
tok = jnp.ones((2, 1), jnp.int32)
lg_ref, _ = decode_step(fakeq, tok, caches, jnp.int32(8), base)
with mesh:
    lg_pk, _ = jax.jit(lambda p, t, c: decode_step(
        p, t, c, jnp.int32(8), scfg_m, mesh=mesh, rules=rules))(served, tok, caches)
out["decode_ref"], out["decode_pk"] = np.asarray(lg_ref), np.asarray(lg_pk)

from repro.serving.scheduler import BatchScheduler, Request
def from_defs(defs, prefix):
    if not isinstance(defs, dict):
        return J(prefix)
    return {k: from_defs(v, f"{prefix}/{k}") for k, v in defs.items()}
prompts = [J(f"paged_prompt{i}") for i in range(3)]
for arch in PAGED_ARCHS:
    pc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    for mode in ("chunked", "serial"):
        with mesh:
            sched = BatchScheduler(pc, from_defs(model_defs(pc), f"paged_{arch}"),
                                   n_slots=4, max_len=64,
                                   mesh=mesh, rules=rules, prefill=mode)
            for i, pr in enumerate(prompts):
                sched.submit(Request(uid=i, prompt=pr, max_new_tokens=6))
            done = sorted(sched.run_to_completion(), key=lambda r: r.uid)
        meta[f"paged/{arch}/{mode}"] = [[int(t) for t in r.output] for r in done]
np.savez(dst, **out)
print("META", json.dumps(meta))
"""


def _inputs(path: str) -> None:
    """Seeded inputs as the reference's tests draw them, and the
    reference's parameters."""
    d = {"gd_w": np.random.default_rng(0).normal(size=(64, 32)).astype(np.float32)}
    mcfg = j_smoke("qwen3_moe_235b_a22b")
    d.update(ranks.flatten(j_init_params({"m": j_moe_def(mcfg)}, seed=1)["m"],
                           "moe_params"))
    d.update(ranks.flatten(j_init_params({"blocks": {"moe": j_moe_def(mcfg)}}, seed=1,
                                         dtype_override="float32")["blocks"]["moe"],
                           "moe_params32"))
    d["moe_x"] = np.random.default_rng(2).normal(
        size=(2, 16, mcfg.d_model)).astype(np.float32)
    rng = np.random.default_rng(0)
    d["pp_ws"] = (rng.normal(size=(4, 16, 16)).astype(np.float32) / 4)
    d["pp_x"] = rng.normal(size=(8, 16)).astype(np.float32)
    qcfg = j_smoke("qwen2_7b")
    d.update(ranks.flatten(j_init_params(j_model_defs(qcfg), seed=0,
                                         dtype_override="float32"), "qwen_params"))
    d.update(ranks.flatten(j_init_params(j_model_defs(mcfg), seed=0,
                                         dtype_override="float32"), "qmoe_params"))
    rng = np.random.default_rng(0)
    for s in range(3):
        for k in ("tokens", "labels"):
            d[f"batch{s}_{k}"] = rng.integers(0, qcfg.vocab_size, (4, 32)).astype(np.int32)
    # masked labels, most of them in the first data shard's rows: its CE
    # averages 10 tokens, the other's 64
    d["batch1_labels"][:2, 5:] = -1
    rng = np.random.default_rng(5)
    for i, n in enumerate((19, 23)):
        d[f"sched_prompt{i}"] = rng.integers(0, 256, n).astype(np.int32)
    for arch in ranks.PAGED_ARCHS:
        pcfg = dataclasses.replace(j_smoke(arch), dtype="float32")
        d.update(ranks.flatten(referee.numpy_params(j_model_defs(pcfg), 0), f"paged_{arch}"))
    rng = np.random.default_rng(7)
    for i, n in enumerate((20, 22, 21)):
        d[f"paged_prompt{i}"] = rng.integers(0, 256, n).astype(np.int32)
    np.savez(path, **d)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    src, dst = str(tmp / "inputs.npz"), str(tmp / "reference.npz")
    ranks.draw_inputs("test_torch_distributed", src, ROOT)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}

    ref = ranks.reference_run(textwrap.dedent(REFERENCE),
                              [src, dst, *ranks.PAGED_ARCHS], env, ROOT)
    port = ranks.spawn(ranks.distributed_cases, WORLD, src, str(tmp / "ckpt"),
                       abort=ranks.reference_failed(ref))
    meta = json.loads(ranks.finish(ref).split("META ", 1)[1])
    return dict(np.load(src)), dict(np.load(dst)), meta, port


def _close(got, want, rel=1e-4) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert err < tol, (err, tol)


def _leafwise(got: dict, want: dict, rel: float) -> None:
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


@pytest.mark.parametrize("shape", [dict(data=2, model=2), dict(pod=2, data=16, model=16),
                                   dict(data=4)])
@pytest.mark.parametrize("global_batch", [None, 8, 6])
def test_sharding_rules_match_reference(shape, global_batch):
    """Rules, specs, FSDP axes, batch specs and the parameter specs of a
    model equal the reference's, entry for entry."""
    from repro.models import sharding as jshd
    from repro.models.params import param_pspecs as j_param_pspecs
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import param_pspecs
    mesh = FakeMesh(**shape)
    rules, jrules = (shd.rules_for_mesh(mesh, global_batch),
                     jshd.rules_for_mesh(mesh, global_batch))
    assert rules.table == jrules.table
    assert shd.fsdp_axes(mesh) == jshd.fsdp_axes(mesh)
    for extra in (1, 3):
        assert tuple(shd.batch_spec(rules, extra)) == tuple(jshd.batch_spec(jrules, extra))
    for axes in (("embed", "mlp"), ("vocab", "embed_no_fsdp"), ("layers", "heads", None),
                 ("batch", "cache_seq", "kv_heads", "head_dim")):
        assert tuple(rules(axes)) == tuple(jrules(axes))
    def specs(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: tuple(tree)}
        return {k: v for n, t in tree.items() for k, v in specs(t, f"{prefix}/{n}").items()}
    got = specs(param_pspecs(model_defs(get_smoke_config("qwen2_7b")), rules))
    assert got == specs(j_param_pspecs(j_model_defs(j_smoke("qwen2_7b")), jrules))
    from repro_torch.models.params import param_shardings
    pairs = param_shardings(model_defs(get_smoke_config("qwen2_7b")), mesh, rules)
    assert pairs["embed"]["table"] == (mesh, rules(("vocab", "embed_no_fsdp")))


def test_constrain_slices_and_relayouts(run):
    """``sharding.constrain`` on 2 x 2 is the reference's
    ``with_sharding_constraint``: a whole tensor comes back as this rank's
    block under the rules (and placed), a placed block moves by collectives
    to another spec, a block already at its spec comes back as it is, and
    an all-None spec gathers it whole.  The logical axes must fit the
    tensor and map to the rules' mesh axes; without rules nothing moves."""
    from repro_torch.models import sharding as shd
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    for res in run[3]:
        d, m = res["coord"]
        block, bspec, gshape, moved, mspec, same, whole = res["constrain"]
        np.testing.assert_array_equal(block, x[2 * d:2 * d + 2, 3 * m:3 * m + 3])
        assert bspec == ("data", "model") and gshape == (4, 6)
        np.testing.assert_array_equal(moved, x[2 * m:2 * m + 2, 3 * d:3 * d + 3])
        assert mspec == ("model", "data") and same
        np.testing.assert_array_equal(whole, x)
    t = torch.zeros(2, 3, 4)
    rules = shd.rules_for_mesh(FakeMesh(data=2, model=2))
    assert shd.constrain(t, ("batch", None, "vocab"), None) is t
    with pytest.raises(ValueError, match="logical axes"):
        shd.constrain(t, ("batch", None), rules)
    with pytest.raises(ValueError, match="not axes of the mesh"):
        shd.constrain(t, ("batch", None, "vocab"), shd.rules_for_mesh(FakeMesh(data=2)))


def test_shard_map_enters_local_blocks_and_gathers(run):
    """``sharding.shard_map`` on 2 x 2: the body sees this rank's block of
    each argument and its collectives; the result is global."""
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    for res in run[3]:
        blocks, summed = res["shard_map"]
        np.testing.assert_array_equal(blocks, x * 2 + 1)
        # psum over "model" of each (data-row block, model-column block):
        # the two column halves added, gathered over data
        np.testing.assert_array_equal(summed, x[:, :3] + x[:, 3:])
        # shard_leaf: ("embed", "mlp") -> ("data", "model"), this rank's block
        d, m = res["coord"]
        np.testing.assert_array_equal(res["shard_leaf"], x[2 * d:2 * d + 2, 3 * m:3 * m + 3])


WORLD_OF_ONE = """
import torch, torch.distributed as dist
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
m = make_host_mesh(1, 1, device="cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
print(m.mesh_dim_names, tuple(m.shape), m.device_type)
try:
    make_production_mesh(device="cpu")
except ValueError as e:
    print("refused:", e)
"""


def test_world_of_one_mesh_starts_its_own_group():
    """Without a process group and on a world of 1, ``make_host_mesh``
    starts gloo (``device="cpu"``) from a ``HashStore``; the production
    shapes are built only on a world of their size."""
    env = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    r = subprocess.run([sys.executable, "-c", WORLD_OF_ONE], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "('data', 'model') (1, 1) cpu"
    assert lines[1] == "refused: mesh {'data': 16, 'model': 16} needs 256 ranks; " \
        "the world has 1"


def test_elastic_remesh_plan():
    for kw in (dict(n_devices=512, model_parallel=16, global_batch=256, pods=2),
               dict(n_devices=128, model_parallel=16, global_batch=256)):
        got, want = plan_remesh(**kw), j_plan_remesh(**kw)
        assert (got.old_shape, got.new_shape, got.axis_names, got.relower,
                got.notes) == (want.old_shape, want.new_shape, want.axis_names,
                               want.relower, want.notes)
    assert plan_remesh(512, 16, 256, pods=2).new_shape == (2, 16, 16)
    for kw in (dict(n_devices=100, model_parallel=16, global_batch=256),
               dict(n_devices=512, model_parallel=16, global_batch=100, pods=2)):
        with pytest.raises(ValueError):
            plan_remesh(**kw)


@pytest.mark.parametrize("pattern", ["col", "row"])
def test_gather_dequant_both_patterns_match_local(run, pattern):
    for res in run[3]:
        _close(res[f"gd_{pattern}"], res["gd_want"], rel=1e-5)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_moe_shard_map_matches_local(run, kind):
    _, ref, meta, port = run
    for res in port:
        y_l, a_l, y_d, a_d = res[f"moe_{kind}"]
        assert float(np.abs(y_l - y_d).max()) < 1e-4
        assert abs(float(a_l) - float(a_d)) < 1e-4
        _close(y_d, ref[f"moe_{kind}"])
        assert abs(float(a_d) - meta[f"moe_{kind}_aux"]) < 1e-4


def test_moe_on_fsdp_only_mesh_serves_local_path(run):
    """A mesh without a "model" axis runs the reference's local MoE path; a
    mesh-aware plan's stacks are blocks there, gathered packed (4 ranks)."""
    for res in run[3]:
        dist, y, aux = res["moe_fsdp_only"]
        y_l, a_l, _, _ = res["moe_packed"]
        assert dist == {"sharded:grouped_gather": 3}
        assert float(np.abs(y - y_l).max()) < 1e-4 and abs(float(aux - a_l)) < 1e-4


def test_pipeline_parallel_matches_sequential(run):
    inputs, ref, _, port = run
    ws, y = inputs["pp_ws"], inputs["pp_x"]
    for i in range(4):
        y = np.tanh(y @ ws[i])
    for res in port:
        assert float(np.abs(res["pp"] - y).max()) < 1e-5
        assert float(np.abs(res["pp"] - ref["pp"]).max()) < 1e-5


def _metrics_close(steps: list) -> None:
    """Per step, every metric's ZeRO-3 value within 1e-4 relative of the
    single device's."""
    for st in steps:
        for k, (one, zero) in st.items():
            assert abs(one - zero) <= 1e-4 * abs(one), (k, one, zero)


def _mostly_leafwise(got: dict, want: dict, rel: float, frac: float) -> None:
    """All but ``frac`` of each leaf's elements within ``rel`` of its
    largest value (the gradient codec is discontinuous)."""
    assert got.keys() == want.keys()
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        off = float((np.abs(np.asarray(got[k], np.float64) - want[k]) > rel * scale).mean())
        assert off <= frac, (k, off)


def test_zero3_train_step_matches_single_device(run):
    """Three train steps on 2 x 2 (``make_train_step(mesh=)``, the train
    layout, for OLMo and Qwen2; the ZeRO-3 step, ``steps._zero3_step``,
    called directly for Qwen3-MoE, whose whole-batch routing this case
    holds) against three single-device steps (the second batch masks most labels
    of one data shard's rows, so each rank's gradient must count its share
    of the labelled tokens) (OLMo's smoke config at f32 activations;
    Qwen2's k bias has an exactly
    zero gradient, whose rounding noise AdamW turns into +-lr steps in any
    two runs): loss and grad norm within 1e-4 relative (the gradient is
    summed over two halves of the batch, f32 sums in another order), every
    parameter and moment within 1e-5 of its leaf's largest value; each rank
    stores less than half of the parameters.  The same on Qwen3-MoE's smoke
    config at capacity factor 1 (tokens drop, so slots must be counted over
    the whole batch, and aux, nonlinear in the load-balance fractions, must
    come from the whole batch's), its aux among the metrics.  With gradient
    compression (OLMo): metrics within 1e-4 relative, and all but 0.1% of
    every parameter, moment and error-feedback residual within 1e-4 of its
    leaf's largest value (the codec is discontinuous: the two steps' f32
    gradients differ in their last bits, which moves a few elements to the
    neighbouring code).  At the config's own activation dtype, as the
    reference's test runs it, the first loss within 5e-3 of the reference's
    sharded step on the Auto-axis mesh (and of its single-device step), for
    Qwen2 and for Qwen3-MoE (its aux within 1e-3 relative of both: the
    reference's sharded step routes in the expert-parallel body, which
    means the fractions over the mesh; its capacity factor 4 drops no
    token, so per-shard capacity there routes as one device does)."""
    _, _, meta, port = run
    for res in port:
        for l1, l3, g1, g3 in res["train_loss"]:
            assert abs(l1 - l3) <= 1e-4 * abs(l1) and abs(g1 - g3) <= 1e-4 * abs(g1)
        _leafwise(res["train_zero3"], res["train_single"], 1e-5)
        assert res["train_local_bytes"] < res["train_global_bytes"] / 2
        steps, single, zero3 = res["train_moe"]
        assert all(st["aux"][0] > 0 for st in steps)
        _metrics_close(steps)
        _leafwise(zero3, single, 1e-5)
        steps, single, zero3 = res["train_compressed"]
        assert any(k.startswith("ef/") for k in single)
        _metrics_close(steps)
        _mostly_leafwise(zero3, single, 1e-4, 1e-3)
        loss = res["train_loss_config_dtype"]
        assert abs(loss - meta["train_loss_sharded"]) < 5e-3
        assert abs(loss - meta["train_loss_single"]) < 5e-3
        loss, aux = res["train_moe_loss_config_dtype"]
        for want, want_aux in (meta["train_moe_sharded"], meta["train_moe_single"]):
            assert abs(loss - want) < 5e-3
            assert abs(aux - want_aux) <= 1e-3 * want_aux, (aux, want_aux)


def test_train_layout_at_capacity_one_matches_the_references_sharded_step(run):
    """Qwen3-MoE's smoke config at capacity factor 1 and f32 activations on
    2 x 2: tokens drop, and the train layout routes each data rank's rows
    with its own capacity (the reference's ``t_local``), so its step is not
    one device's; its first loss and aux are the reference's sharded step's
    on the Auto-axis mesh within 1e-4 relative."""
    _, _, meta, port = run
    want_loss, want_aux = meta["train_moe_c1_sharded"]
    for res in port:
        loss, aux = res["train_moe_c1"]
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss), (loss, want_loss)
        assert abs(aux - want_aux) <= 1e-4 * abs(want_aux), (aux, want_aux)


def test_elastic_checkpoint_round_trip(run):
    """Saved from 2 x 2 as logical arrays: restored bit for bit; a ZeRO-3
    step on data = 4 from it equals a single-device step from it."""
    for res in run[3]:
        assert res["restored_step"] == 3 and res["restored_equal"]
        l4, l1, p4, p1 = res["elastic"]
        assert abs(l4 - l1) <= 1e-4 * abs(l1)
        _leafwise(p4, p1, 1e-5)


def test_packed_decode_matches_dense_decode_distributed(run):
    _, ref, _, port = run
    for res in port:
        lg_ref, lg_pk = res["decode"]
        assert float(np.abs(lg_pk - lg_ref).max()) < 2e-3
        assert float(np.abs(lg_pk - ref["decode_pk"]).max()) < 2e-3
        assert float(np.abs(lg_ref - ref["decode_ref"]).max()) < 2e-3


def test_meshless_plan_decodes_in_the_sharded_layout(run):
    """A plan built without a mesh serves on one: ``shard_params`` keeps its
    whole packed leaves and the ``sharded:*`` variants cut each to this
    rank's block per use, so the logits are the mesh-aware plan's."""
    _, ref, _, port = run
    for res in port:
        lg_ref, lg_pk = res["decode"]
        lg_ml = res["decode_meshless"]
        assert float(np.abs(lg_ml - lg_ref).max()) < 2e-3
        assert float(np.abs(lg_ml - ref["decode_pk"]).max()) < 2e-3
        np.testing.assert_array_equal(lg_ml, lg_pk)


def test_batch_scheduler_on_mesh_matches_single_device(run):
    for res in run[3]:
        want, got, dist = res["sched"]
        assert got == want
        assert set(dist) == {"sharded:gather_dequant"}


def test_serve_mesh_matches_one_device(run):
    for res in run[3]:
        a, b, dist, mesh_line = res["serve"]
        assert a == b
        assert set(dist) == {"sharded:gather_dequant"}
        assert mesh_line == "mesh: {'data': 2, 'model': 2} (cpu)"


PAGED = [(arch, mode) for arch in ranks.PAGED_ARCHS for mode in ("chunked", "serial")]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,mode", PAGED, ids=[f"{a}-{m}" for a, m in PAGED])
def test_paged_mesh_scheduler_matches_one_device_and_reference(run, arch, mode):
    """``BatchScheduler(mesh=)`` on 2 x 2 in the paged layout (the decode
    lane's 4 slots over data, 2 a rank; the batch-1 prefill lanes whole on
    every rank), teacher-forced with one device's tokens, predicts one
    device's tokens, which are the reference's scheduler's on an Auto-axis
    2 x 2 mesh; every lane's logits (the decode lane's all-gathered) are
    one device's within rtol 1e-4 / atol 1e-5."""
    _, _, meta, port = run
    for res in port:
        out = res["paged_mesh"][f"{arch}/{mode}"]
        assert out["tokens_mesh"] == out["tokens_one"] == meta[f"paged/{arch}/{mode}"]
        one, mesh = out["lanes_one"], out["lanes_mesh"]
        assert [n for n, *_ in mesh] == [n for n, *_ in one]
        for (name, got, _), (_, want, _) in zip(mesh, one):
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ranks.PAGED_ARCHS)
def test_paged_lanes_compute_this_ranks_rows(run, arch):
    """Every decode call of attention and of the SSM mixer on a rank is
    handed its 2 of the 4 slots (data coordinate d: slots 2d, 2d + 1) and
    those rows of the page table; on one device all 4."""
    for res in run[3]:
        d, _ = res["rows"]
        for mode in ("chunked", "serial"):
            out = res["paged_mesh"][f"{arch}/{mode}"]
            tables = [t for name, _, t in out["lanes_mesh"] if name == "_decode"]
            for run_name, rows in (("mesh", slice(2 * d, 2 * d + 2)), ("one", slice(0, 4))):
                seen = out[f"seen_{run_name}"]
                attn = [s for s in seen if s[0] == "attn"]
                assert seen and all(s[1] == rows.stop - rows.start for s in seen)
                assert all(s[2] == rows.stop - rows.start for s in seen if s[0] == "ssm")
                if attn and run_name == "mesh":
                    per_tick = len(attn) // len(tables)
                    assert per_tick * len(tables) == len(attn)
                    for i, (_, _, table) in enumerate(attn):
                        np.testing.assert_array_equal(table, tables[i // per_tick][rows])


@pytest.mark.parametrize("arch", ranks.PAGED_ARCHS)
def test_paged_mesh_pools_and_tails_equal_on_every_rank(run, arch):
    """After the run every rank's pools, tails and SSM ``conv`` / ``state``
    are byte-equal to each other's; to one device's byte-equal for the
    attention-only stacks, and within 1e-5 of each leaf's largest value for
    the SSM ones: the CPU's vectorized ``softplus`` and ``silu`` round the
    last, partial SIMD vector of a tensor apart from full ones, so a
    2-slot batch's dt and gates differ from a 4-slot batch's in the last
    bit (measured 2.4e-7 for Mamba-2, 8.3e-7 for Jamba, whose attention
    reads the SSM layers' output).  The decode lane gathers, per run, each
    slot's new tail row and the whole SSM rows, and nothing more."""
    port = run[3]
    ssm = arch in ("mamba2_780m", "jamba_1_5_large_398b")
    for mode in ("chunked", "serial"):
        outs = [res["paged_mesh"][f"{arch}/{mode}"] for res in port]
        for part in ("pools", "hot"):
            for out in outs:
                got, one = out[f"{part}_mesh"], out[f"{part}_one"]
                assert got.keys() == one.keys() == outs[0][f"{part}_mesh"].keys()
                for k in got:
                    np.testing.assert_array_equal(got[k], outs[0][f"{part}_mesh"][k])
                    if ssm:
                        scale = max(float(np.abs(one[k]).max()), 1e-30)
                        assert float(np.abs(got[k] - one[k]).max()) <= 1e-5 * scale, k
                    else:
                        np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        hot = outs[0]["hot_one"]
        per_run = sum(v.nbytes // v.shape[2] if k.endswith("_tail") else v.nbytes
                      for k, v in hot.items())
        moved, runs = outs[0]["gathered_mesh"]
        assert runs > 0 and moved == per_run * runs


def test_tp_train_grads_are_blocks_of_one_devices(run):
    """The dense decoders' train layout on 2 x 2 (OLMo and Qwen2 smoke,
    f32): each rank's loss is one device's within 1e-4 relative, and its
    gradients are exactly the blocks one device's cut to under the rules,
    shape for shape, every value within 1e-5 of its leaf's largest."""
    for res in run[3]:
        for arch in ("olmo_1b", "qwen2_7b"):
            one, tp = res["tp_train"][f"{arch}/loss"]
            assert abs(one - tp) <= 1e-4 * abs(one)
            grads = res["tp_train"][f"{arch}/grads"]
            assert grads
            for k, (got, want) in grads.items():
                assert got.shape == want.shape, k
                scale = max(float(np.abs(want).max()), 1e-30)
                assert float(np.abs(got - want).max()) <= 1e-5 * scale, k


def test_tp_train_activations_are_column_blocks(run):
    """In the dataflow trace of one train forward, one device's matmuls are,
    in order, each layer's q, k, v, o, MLP in, gate and out products and
    the LM head; a rank's (model = 2) are the same with half the columns of
    the column-parallel ones (q, k, v, the MLP's in and gate, the head's
    vocabulary) and half the rows of the row-parallel ones (o, MLP out)."""
    from repro_torch.configs.base import get_smoke_config
    for res in run[3]:
        for arch in ("olmo_1b", "qwen2_7b"):
            cfg = get_smoke_config(arch)
            d, q, kv, f = cfg.d_model, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd, cfg.d_ff
            layer = [(d, q, "col"), (d, kv, "col"), (d, kv, "col"), (q, d, "row"),
                     (d, f, "col"), (d, f, "col"), (f, d, "row")]
            want = layer * cfg.n_layers + [(d, cfg.padded_vocab, "col")]
            one = [tuple(m) for m in res["tp_train"][f"{arch}/mm_one"]]
            rank = [tuple(m) for m in res["tp_train"][f"{arch}/mm_rank"]]
            assert one == [(k, n) for k, n, _ in want], arch
            assert rank == [(k, n // 2) if p == "col" else (k // 2, n)
                            for k, n, p in want], arch


@pytest.mark.parametrize("what", ["x", "v"])
def test_collective_transposes_match_finite_differences(run, what):
    """The backward of ``all_gather`` (sum over the group, this rank's
    block), ``all_reduce`` (identity) and ``grad_all_reduce`` (sum) against
    central differences of one f64 function on 2 x 2 (``x`` each rank's
    block, perturbed on one rank at a time; ``v`` equal on the model group,
    perturbed on all of it), within 1e-6 relative."""
    for res in run[3]:
        got, want = res["tp_train"]["fd"][what]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
