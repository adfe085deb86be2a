"""The sharded serving layout (the reference's ``input_shardings``) against
the JAX reference, on the CPU.

Every family's prefill and decode steps on a mesh hold every input at the
reference's spec and compute on their blocks (``models.sharding``).  One
module fixture runs the port on 4 gloo ranks (``tests/_torch_ranks.py``)
beside the reference in a subprocess on 4 forced host devices, over
``jax.sharding.Mesh`` meshes built by hand (Auto axes; jax 0.9's
``jax.make_mesh`` makes Explicit ones).  Weights come from a numpy seed, the
packed plan's payloads are the port's (carried to the reference, whose
eager packing they equal), prompts from a numpy seed.  Cases
(``_torch_ranks.SPMD_CASES``), every one at f32 activations:

* the dense GQA decoders: the OLMo and Qwen2 smoke configs, dense and
  mip2q-packed, on 2 x 2, 1 x 4 and 4 x 1 with a batch of 4, and on 2 x 2
  with a batch of 3, which the data axis does not divide (the batch is then
  replicated, as the reference's ``batch_axes`` replicates it); and Qwen2's
  smoke config with 6 query heads over 2 kv heads on 1 x 4, dense, where a
  rank's block of the q columns is 1.5 heads and of the k / v columns half
  a head;
* the MoE, SSM and hybrid families: the Moonshot smoke config (dense and
  mip2q), Mamba-2's (dense and mip2q, and dense with its split
  projections) and Jamba's (dense), each on 2 x 2 and 1 x 4 with a batch of
  4 and on 2 x 2 with a batch of 3.  The smoke MoE configs route at most
  one assignment of a token to an expert and their capacity (``top_k /
  n_experts x capacity_factor = 2`` slots a token) is twice the rows a
  rank routes, so neither the mesh run nor the single-device run drops a
  token: the MoE cases are held to both, as the others are.

Held:

* every parameter and cache leaf on every rank has the shape of the
  reference's ``NamedSharding(mesh, spec).shard_shape(...)``; a parameter
  block equals that block (``devices_indices_map``) of the carried-over
  weights exactly, a prefill cache block equals that block of the
  reference's prefill cache within 1e-5 (f32 sums in another order);
* the logits of the prefill and of four greedy decode steps equal the
  reference's run on a mesh of the same shape, jitted with
  ``in_shardings=input_shardings(...)``, and its single-device run within
  rtol 1e-4 / atol 1e-5 (f32: summation order only); the greedy tokens are
  equal; ``serve(mesh=)`` gives the same tokens and logits;
* rank 0's argument bytes that the dry-run counts for the decode_32k cells
  of OLMo-1B, Moonshot-16B-A3B and Mamba-2 780M (dense, 16 x 16, on
  ``meta``) equal the sum of the reference's shard sizes of that cell (a
  subprocess on 256 forced host devices, from ``input_specs`` and
  ``input_shardings`` through ``shard_shape``, no compile), less the two
  inputs whose dtype the port keeps otherwise: its tokens are int64 where
  the reference's are int32, and its ``cache_len`` is a Python int where
  the reference's is an int32 scalar;
* the lanes the layout does not cover (the train forward without a mesh,
  a step without a mesh, the paged runtime) refuse a sharded dense leaf
  with a message.
"""
import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.core.policy import StruMConfig
from repro_torch.launch import dryrun
from repro_torch.models import model_defs

import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
CASES = [ranks.spmd_case_id(c) for c in ranks.SPMD_CASES]

REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
sys.path.insert(0, "tests")
import _torch_ranks as ranks
from repro.configs.base import ShapeSpec, get_smoke_config
from repro.core.policy import StruMConfig
from repro.launch.serve import pad_caches
from repro.launch.specs import input_shardings, padded_cache_len
from repro.launch.steps import make_decode_step, make_prefill_step
from repro.models import model_defs
from repro.models.sharding import rules_for_mesh

src, dst = sys.argv[1], sys.argv[2]
data = dict(np.load(src))
S, GEN = ranks.SPMD_PROMPT, ranks.SPMD_GEN
L = padded_cache_len(S + GEN)
FIELDS = ("mask", "hi", "lo", "scale")
out = {}

def cfg_of(arch, plan):
    base, over = ranks.SPMD_ARCHS[arch]
    cfg = dataclasses.replace(get_smoke_config(base), dtype="float32", **over)
    if plan == "mip2q":
        cfg = dataclasses.replace(cfg, strum=StruMConfig(method="mip2q", p=0.5, L=5))
    return cfg

def tree(defs, prefix, packed):
    # the carried-over weights; a packed leaf as the port packed it
    if not isinstance(defs, dict):
        if packed and f"pk/{prefix}/mask" in data:
            return {f: jnp.asarray(data[f"pk/{prefix}/{f}"]) for f in FIELDS}
        return jnp.asarray(data[prefix])
    return {k: tree(v, f"{prefix}/{k}", packed) for k, v in defs.items()}

def flat(t, prefix=""):
    if isinstance(t, dict):
        return {k: v for n, s in t.items() for k, v in flat(s, f"{prefix}/{n}" if prefix else n).items()}
    return {prefix: t}

def run(cfg, params, prompt, mesh=None, rules=None, pspecs=None, dspecs=None):
    pf = jax.jit(make_prefill_step(cfg, mesh, rules), in_shardings=pspecs)
    df = jax.jit(make_decode_step(cfg, mesh, rules), in_shardings=dspecs)
    lg, caches = pf(params, {"tokens": prompt})
    caches = pad_caches(caches, L - S)
    if dspecs is not None:
        caches = jax.device_put(caches, dspecs[2])
    first = caches
    steps = [lg[:, -1]]
    toks = [jnp.argmax(lg[:, -1, :cfg.vocab_size], -1).astype(jnp.int32)[:, None]]
    for i in range(GEN):
        lg, caches = df(params, toks[-1], caches, jnp.int32(S + i))
        steps.append(lg[:, -1])
        toks.append(jnp.argmax(lg[:, -1, :cfg.vocab_size], -1).astype(jnp.int32)[:, None])
    return (np.asarray(jnp.stack(steps, 1)), np.asarray(jnp.concatenate(toks, 1)), first)

single = {}
for arch, plan, shape, b in ranks.SPMD_CASES:
    cid = ranks.spmd_case_id((arch, plan, shape, b))
    cfg = cfg_of(arch, plan)
    params = tree(model_defs(cfg), f"w/{arch}", cfg.strum is not None)
    prompt = jnp.asarray(data[f"prompt/{b}"].astype(np.int32))
    if (arch, plan, b) not in single:
        lg, tk, _ = run(cfg, params, prompt)
        single[(arch, plan, b)] = True
        out[f"single/{arch}/{plan}/{b}/logits"], out[f"single/{arch}/{plan}/{b}/tokens"] = lg, tk
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
    rules = rules_for_mesh(mesh, b)
    psh = input_shardings(cfg, ShapeSpec("p", S, b, "prefill"), mesh, rules)
    dsh = input_shardings(cfg, ShapeSpec("d", S + GEN, b, "decode"), mesh, rules)
    with mesh:
        lg, tk, caches = run(cfg, params, prompt, mesh, rules, psh, dsh)
    out[f"{cid}/logits"], out[f"{cid}/tokens"] = lg, tk
    # each leaf's shard shape and every device's block (rank = d * model + m)
    devs = list(mesh.devices.flat)
    for what, arrs, shards in (("leaves", flat(params), flat(dsh[0])),
                               ("caches", flat(caches), flat(dsh[2]))):
        for name, arr in arrs.items():
            sh = shards[name]
            out[f"{cid}/{what}/{name}/shape"] = np.array(sh.shard_shape(arr.shape))
            idx = sh.devices_indices_map(arr.shape)
            out[f"{cid}/{what}/{name}/idx"] = np.array(
                [[(s.start or 0, arr.shape[k] if s.stop is None else s.stop)
                  for k, s in enumerate(idx[d])] for d in devs])
            if what == "caches":
                out[f"{cid}/caches/{name}/whole"] = np.asarray(arr)
np.savez(dst, **out)
print("DONE")
"""

#: the reference's rank-0 shard sizes of decode_32k on 16 x 16, for the
#: archs named on the command line
SHARD_BYTES = """
import json, math, sys
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs.base import SHAPES, get_config
from repro.launch.specs import input_shardings, input_specs
from repro.models.sharding import rules_for_mesh

mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
shape = SHAPES["decode_32k"]
rules = rules_for_mesh(mesh, shape.global_batch)
out = {}
for arch in sys.argv[1:]:
    cfg = get_config(arch)
    specs = input_specs(cfg, shape)
    shards = input_shardings(cfg, shape, mesh, rules)
    sizes = [math.prod(sh.shard_shape(sp.shape)) * sp.dtype.itemsize
             for sp, sh in zip(jax.tree.leaves(specs), jax.tree.leaves(shards))]
    token, cache_len = specs[1], specs[3]
    out[arch] = {"total": sum(sizes),
                 "token_shard": list(shards[1].shard_shape(token.shape)),
                 "token_itemsize": token.dtype.itemsize,
                 "cache_len_bytes": cache_len.dtype.itemsize}
print("META", json.dumps(out))
"""


def _draw(defs, rng, prefix, out):
    """Seeded numpy weights of a ``ParamDef`` tree, by path."""
    for k, d in defs.items():
        name = f"{prefix}/{k}"
        if isinstance(d, dict):
            _draw(d, rng, name, out)
        elif d.init == "zeros":
            out[name] = np.zeros(d.shape, np.float32)
        elif d.init == "ones":
            out[name] = np.ones(d.shape, np.float32)
        else:
            fan_in = int(np.prod(d.shape[:-1])) if len(d.shape) > 1 else d.shape[0]
            std = d.scale / np.sqrt(fan_in) if d.init == "normal" else d.scale
            out[name] = (rng.standard_normal(d.shape) * std).astype(np.float32)


def _inputs(path: str) -> None:
    """Weights, the port's packed payloads of them and the prompts."""
    from repro_torch import engine
    out = {}
    rng = np.random.default_rng(29)
    # the dense GQA decoders' weights, then the prompts, from one generator;
    # the other families' weights from a second one
    dense = ("olmo_1b", "qwen2_7b", "qwen2_7b_h6")
    for arch in dense:
        _draw(model_defs(ranks.spmd_cfg(arch, "mip2q")), rng, f"w/{arch}", out)
    for b in {c[3] for c in ranks.SPMD_CASES}:
        out[f"prompt/{b}"] = rng.integers(0, 256, size=(b, ranks.SPMD_PROMPT))
    rng = np.random.default_rng(30)
    for arch in ranks.SPMD_ARCHS:
        cfg = ranks.spmd_cfg(arch, "mip2q")
        if arch not in dense:
            _draw(model_defs(cfg), rng, f"w/{arch}", out)
        if not any(c[:2] == (arch, "mip2q") for c in ranks.SPMD_CASES):
            continue
        whole = ranks.tree_from(out, model_defs(cfg), f"w/{arch}")
        plan = engine.build_plan(whole, cfg=cfg.strum, device="cpu")
        for name, e in plan.entries.items():
            for f in ranks.FIELDS:
                out[f"pk/w/{arch}/{name}/{f}"] = e.leaf[f].numpy()
    np.savez(path, **out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results, the reference's arrays and the inputs, the two
    runs side by side."""
    d = tmp_path_factory.mktemp("spmd")
    src, dst = str(d / "in.npz"), str(d / "ref.npz")
    _inputs(src)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    env.pop("STRUM_INTERPRET", None)
    ref = ranks.reference_run(textwrap.dedent(REFERENCE), [src, dst], env, ROOT)
    live = ranks.spawn(ranks.spmd_serving_cases, 4, src,
                       abort=ranks.reference_failed(ref))
    ranks.finish(ref)
    return live, dict(np.load(dst)), dict(np.load(src))


def _case(cid: str):
    return next(c for c in ranks.SPMD_CASES if ranks.spmd_case_id(c) == cid)


def _block(whole: np.ndarray, idx: np.ndarray, rank: int) -> np.ndarray:
    return whole[tuple(slice(a, b) for a, b in idx[rank])]


@pytest.mark.parametrize("cid", CASES)
def test_every_leaf_is_the_references_shard(run, cid):
    """Parameters exactly, caches within 1e-5: each rank's block of each
    leaf has the reference's shard shape and holds that block."""
    live, ref, inputs = run
    arch = _case(cid)[0]
    for rank, res in enumerate(live):
        got = res[cid]["leaves"]
        pre = f"{cid}/leaves/"
        assert set(got) == {k[len(pre):].rsplit("/", 1)[0] for k in ref
                            if k.startswith(pre)}
        for name, block in got.items():
            key = pre + name
            assert block.shape == tuple(ref[f"{key}/shape"]), name
            # a packed field: the port's payload the reference served
            whole = inputs.get(f"pk/w/{arch}/{name}", inputs.get(f"w/{arch}/{name}"))
            np.testing.assert_array_equal(block, _block(whole, ref[f"{key}/idx"], rank),
                                          err_msg=name)
        for name, block in res[cid]["caches"].items():
            key = f"{cid}/caches/{name}"
            assert block.shape == tuple(ref[f"{key}/shape"]), name
            np.testing.assert_allclose(block, _block(ref[f"{key}/whole"],
                                                     ref[f"{key}/idx"], rank),
                                       rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cid", CASES)
def test_logits_and_tokens_match_the_reference(run, cid):
    """Prefill and four greedy decode steps: the ranks' logits (gathered
    whole) against the reference's sharded run and its single-device run;
    tokens equal; ``serve(mesh=)`` the same."""
    live, ref, _ = run
    arch, plan, _, b = _case(cid)
    single = f"single/{arch}/{plan}/{b}"
    for res in live:
        r = res[cid]
        assert r["logits"].shape == ref[f"{cid}/logits"].shape
        np.testing.assert_allclose(r["logits"], ref[f"{cid}/logits"], **TOL)
        np.testing.assert_allclose(r["logits"], ref[f"{single}/logits"], **TOL)
        np.testing.assert_array_equal(r["tokens"], ref[f"{cid}/tokens"])
        np.testing.assert_array_equal(r["tokens"], ref[f"{single}/tokens"])
        tokens, logits = r["serve"]
        np.testing.assert_array_equal(tokens, r["tokens"])
        np.testing.assert_allclose(logits, r["logits"], **TOL)


def test_batch_the_data_axis_does_not_divide_is_replicated(run):
    """Batch 3 on data = 2: the caches hold every row (batch replicated),
    an attention cache's sequence split over ``model``, an SSM ``conv``
    cache's channels and ``state``'s heads too, as the reference's specs
    say."""
    live, ref, _ = run
    for res in live:
        olmo3, olmo4 = res["olmo_1b-dense-2x2-b3"], res["olmo_1b-dense-2x2-b4"]
        assert olmo3["cache_specs"]["pos0/k"] == (None, None, "model", None, None)
        assert olmo3["caches"]["pos0/k"].shape[1] == 3
        assert olmo4["cache_specs"]["pos0/k"] == (None, "data", "model", None, None)
        for b, rows in ((3, None), (4, "data")):
            specs = res[f"mamba2_780m-dense-2x2-b{b}"]["cache_specs"]
            assert specs["pos0/conv"] == (None, rows, None, "model")
            assert specs["pos0/state"] == (None, rows, "model", None, None)
            jamba = res[f"jamba_1_5_large_398b-dense-2x2-b{b}"]["cache_specs"]
            assert jamba["pos1/k"] == (None, rows, "model", None, None)
            assert jamba["pos0/conv"] == (None, rows, None, "model")


def _shard_bytes(archs) -> dict:
    """The reference's rank-0 shard sizes of ``archs``' decode_32k cells on
    16 x 16 (a subprocess on 256 forced host devices)."""
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=256",
           "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    p = ranks.reference_run(SHARD_BYTES, list(archs), env, ROOT, timeout=300)
    return json.loads(ranks.finish(p).split("META ", 1)[1])


def _port_argument_bytes(meta: dict) -> int:
    """The reference's shard sizes as the port holds the same inputs: the
    token int64 where the reference's is int32, ``cache_len`` a Python
    int."""
    tokens = int(np.prod(meta["token_shard"]))
    return meta["total"] + tokens * (8 - meta["token_itemsize"]) - meta["cache_len_bytes"]


def test_decode_32k_argument_bytes_equal_the_references_shards():
    """Rank 0 of 16 x 16, OLMo-1B decode_32k, dense: the dry-run's argument
    bytes are the reference's shard sizes, but for the token (int64 here,
    int32 there) and ``cache_len`` (a Python int here, 4 bytes there)."""
    rec = dryrun.lower_cell("olmo_1b", "decode_32k", mesh="16x16")
    meta = _shard_bytes(["olmo_1b"])["olmo_1b"]
    assert rec["layout"] == "input_shardings"
    assert rec["memory"]["argument_bytes"] == _port_argument_bytes(meta)
    assert meta["total"] == 2_202_337_316
    # the count moves link bytes (FSDP gathers, row all-reduces, the
    # vocab-parallel embedding, the flash-decode merge) and splits the work
    one = dryrun.lower_cell("olmo_1b", "decode_32k")
    assert rec["link_bytes_per_dev"] > 0
    assert rec["flops_per_dev"] < one["flops_per_dev"] / 200


#: the reference's rank-0 shard sums of decode_32k on 16 x 16
MOE_SSM_SHARD_TOTALS = {"moonshot_v1_16b_a3b": 9_968_160_804,
                        "mamba2_780m": 53_664_132}


def test_moe_and_ssm_decode_32k_argument_bytes_equal_the_references_shards():
    """Rank 0 of 16 x 16, Moonshot-16B-A3B and Mamba-2 780M decode_32k,
    dense: the dry-run counts them in the sharded serving layout, and their
    argument bytes are the reference's shard sizes but for the token and
    ``cache_len``, under a hundredth of one H100's (the expert stacks split
    over ``model`` alone)."""
    metas = _shard_bytes(MOE_SSM_SHARD_TOTALS)
    for arch, total in MOE_SSM_SHARD_TOTALS.items():
        rec = dryrun.lower_cell(arch, "decode_32k", mesh="16x16")
        assert metas[arch]["total"] == total
        assert rec["layout"] == "input_shardings"
        assert rec["memory"]["argument_bytes"] == _port_argument_bytes(metas[arch])
        assert rec["link_bytes_per_dev"] > 0
        one = dryrun.lower_cell(arch, "decode_32k")
        assert rec["memory"]["argument_bytes"] * 100 < one["memory"]["argument_bytes"]


def test_uncovered_lanes_refuse_a_sharded_dense_leaf():
    """A sharded dense leaf reaching a lane that holds whole dense params
    raises: the MoE family's train forward without a mesh, a step without
    a mesh, the paged runtime."""
    res = ranks.spawn(ranks.spmd_uncovered_cases, 4)
    for r in res:
        for lane in ("train", "no_mesh", "paged"):
            assert "sharded dense leaf" in r[lane], (lane, r[lane])


def test_every_family_serves_in_the_sharded_layout():
    """``sharded_serving`` on a mesh, and the dry-run's layout of every
    serving cell (and the train layout of every train cell), for every
    config of the reference; never without a mesh."""
    from repro_torch.configs.base import ARCH_IDS, get_config
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.transformer import sharded_serving
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert sharded_serving(cfg, mesh) and not sharded_serving(cfg, None), arch
        for kind in ("prefill", "decode"):
            assert dryrun.layout_of(cfg, kind, mesh) == "input_shardings"
        assert dryrun.layout_of(cfg, "train", mesh) == "tp_train", arch


@pytest.mark.parametrize("arch", ["moonshot_v1_16b_a3b", "mamba2_780m",
                                  "mamba2_780m_split", "jamba_1_5_large_398b"])
def test_moe_and_ssm_defs_twin_the_references_axes(arch):
    """The parameter and cache trees of the MoE, SSM and hybrid smoke
    configs name the reference's logical axes leaf for leaf (``experts``,
    ``expert_fsdp``, ``conv``, ``ssm_inner``, ``ssm_heads``,
    ``ssm_state``), so ``shard_params`` cuts what ``input_shardings``
    does."""
    from repro.configs.base import get_smoke_config as j_smoke
    from repro.models import cache_defs as j_cache_defs
    from repro.models import model_defs as j_model_defs
    from repro_torch.models import cache_defs

    def axes(tree, prefix=""):
        if hasattr(tree, "axes"):
            return {prefix: (tuple(tree.shape), tuple(tree.axes))}
        return {k: v for n, t in tree.items()
                for k, v in axes(t, f"{prefix}/{n}").items()}
    base, over = ranks.SPMD_ARCHS[arch]
    cfg = ranks.spmd_cfg(arch, "dense")
    jcfg = dataclasses.replace(j_smoke(base), dtype="float32", **over)
    assert axes(model_defs(cfg)) == axes(j_model_defs(jcfg))
    assert axes(cache_defs(cfg, 4, 16)) == axes(j_cache_defs(jcfg, 4, 16))
    names = {a for _, ax in axes(model_defs(cfg)).values() for a in ax}
    family = {"moonshot_v1_16b_a3b": {"experts", "expert_fsdp"},
              "jamba_1_5_large_398b": {"experts", "conv", "ssm_inner", "ssm_heads"}}
    assert family.get(arch, {"conv", "ssm_inner", "ssm_heads"}) <= names


def test_moe_smoke_cases_drop_no_token():
    """Why the MoE cases hold to the single-device run as well: in every
    case a rank's capacity (the reference's ``t_local``) and one device's
    are at least the rows routed, and an expert gets at most one
    assignment a row, so no assignment drops."""
    from repro_torch.models.moe import _capacity
    for arch, plan, shape, b in ranks.SPMD_CASES:
        cfg = ranks.spmd_cfg(arch, plan)
        if not cfg.n_experts:
            continue
        n_data = shape[0] if b % shape[0] == 0 else 1
        for rows in (b // n_data * ranks.SPMD_PROMPT, b * ranks.SPMD_PROMPT,
                     b // n_data, b):
            assert _capacity(rows, cfg) >= rows, (arch, shape, b, rows)


def test_shard_params_places_dense_leaves_and_keeps_packed_ones():
    """``shard_params`` on a served tree: a dense leaf is cut and says what
    it holds; a packed leaf is kept as it is, a mesh-less plan's whole
    (the ``sharded:*`` variants cut it per use) or this mesh's block; a
    block cut for another mesh raises."""
    from repro_torch import engine
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import abstract_params, init_params, shard_params
    cfg = dataclasses.replace(get_smoke_config("qwen2_7b"), dtype="float32")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    rules = shd.rules_for_mesh(mesh, 4)
    placed = shard_params(abstract_params(model_defs(cfg)), model_defs(cfg), mesh, rules)
    wq = placed["blocks"]["pos0"]["attn"]["wq"]
    pl = shd.placement(wq["w"])
    assert tuple(wq["w"].shape) == (cfg.n_layers, 32, 32)
    assert pl.shape == (cfg.n_layers, 64, 64) and tuple(pl.spec) == (None, "data", "model")
    assert pl.axes == ("layers", "embed", "qkv") and pl.parts == 4
    assert tuple(shd.placement(wq["b"]).spec) == (None, "model")
    assert tuple(placed["embed"]["table"].shape) == (cfg.padded_vocab // 2, cfg.d_model)
    params = init_params(model_defs(cfg), device="cpu")
    whole = engine.build_plan(params, cfg=StruMConfig(), device="cpu").params
    kept = shard_params(whole, model_defs(cfg), mesh, rules, device="cpu")
    assert kept["blocks"]["pos0"]["attn"]["wq"]["w"] is whole["blocks"]["pos0"]["attn"]["wq"]["w"]
    other = AbstractMesh((1, 4), ("data", "model"))
    cut = engine.build_plan(params, cfg=StruMConfig(), mesh=other,
                            rules=shd.rules_for_mesh(other, 4), device="cpu").params
    with pytest.raises(ValueError, match="not this mesh"):
        shard_params(cut, model_defs(cfg), mesh, rules, device="cpu")


def test_decode_cache_len_pads_only_a_split_sequence():
    """``serve``'s cache length: one headroom slot, rounded up to
    ``padded_cache_len`` only where the cache's sequence splits over a
    ``model`` axis of more than one rank."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.serve import decode_cache_len
    from repro_torch.launch.specs import padded_cache_len
    names = ("data", "model")
    assert decode_cache_len(None, 40) == 41
    for shape in ((1, 1), (4, 1)):
        assert decode_cache_len(AbstractMesh(shape, names), 40) == 41
    for shape, n in (((2, 2), 40), ((1, 4), 600)):
        assert decode_cache_len(AbstractMesh(shape, names), n) == padded_cache_len(n)
    assert padded_cache_len(40) == 512 and padded_cache_len(600) == 1024
