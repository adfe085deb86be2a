"""The train layout of the MoE, SSM and hybrid families on a 2 x 2 mesh
against one device and the JAX reference, on the CPU.

``make_train_step(mesh=)`` runs the reference's train layout for every
family (``launch.steps._tp_step``): parameters and AdamW moments are this
rank's shards, each rank takes its rows of the batch over ``data``, the
expert stacks are split over ``model`` (the expert-parallel body under
autograd, ``moe.moe_apply(spmd=True)``), and so are the Mamba-2 mixer's
projections, conv channels, heads and norm scale.  One module fixture
runs the port on 4 gloo ranks (``tests/_torch_ranks.family_train_cases``)
beside the reference's single-device loss in a subprocess, both from
weights drawn by ``_torch_f64_referee.numpy_params`` (seed 0) and batches
from a numpy seed.  Cases: the Qwen3-MoE, Moonshot, Mamba-2 (fused and
``ssm_split_proj``) and Jamba smoke configs at f32 and capacity factor 4
(no token drops).  Held:

* each rank's loss and aux within 1e-4 relative of one device's and of
  the reference's; its gradients the blocks of one device's cut under
  the rules, shape for shape, every value within 1e-5 of its leaf's
  largest; the same with every label -1 (ce = 0: aux alone drives the
  gradient) for Qwen3-MoE and Jamba;
* three mesh steps against three single-device steps: loss, ce, aux and
  grad norm within 1e-4 relative; every parameter and moment within 1e-5
  of its leaf's largest value, or of the learning rate where that is
  larger (AdamW moves every element by up to ``lr`` a step whatever the
  size of its gradient, so an element whose gradient is near zero, such as
  one of the split-projection Mamba-2's zero-initialised ``a_log``, steps
  by an f32 rounding of it: 1.04e-5 of that leaf's 5.6e-5 largest value
  after three steps);
* every expert product of one train forward on a rank is a batched
  product over ``n_experts / 2`` experts, one device's over all of them,
  in the same order;
* Mamba-2 with gradient compression: the metrics within 1e-4 relative;
  in every parameter, moment and error-feedback leaf all but 0.1% of the
  elements (and at least one may) within 1e-4 of its largest value: the
  codec is discontinuous, and its residuals are its rounding, ~1/254 of
  the gradient, so f32 noise in a gradient shows there 254 times larger
  (one of the 16 elements of ``dt_bias``'s residual sits 1.3e-4 off);
* Qwen3-MoE at capacity factor 1 in float64 (tokens drop; each data rank
  routes its rows with its own capacity): autograd's directional
  derivatives along 3 seeded directions within 1e-6 relative of central
  finite differences of the mesh step's loss;
* a ``model`` axis that does not divide the experts (3) or the SSM heads
  (1) raises before any collective, naming the shapes;
* the gradient codec sees the global ``[1, 16]`` blocks of a leaf whose
  local rows are no multiple of 16 (``steps._codec_dims``).
"""
import os
import textwrap

import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import model_defs as j_model_defs

import _torch_f64_referee as referee
import _torch_ranks as ranks

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [c for c, _, _ in ranks.FAMILY_CASES]
MOE_CASES = ["qwen3_moe", "moonshot", "jamba"]
LR = 1e-3          # the steps' AdamWConfig(lr=1e-3) in family_train_cases

REFERENCE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, "tests")
import _torch_ranks as ranks
from repro.configs.base import get_smoke_config
from repro.models import model_defs
from repro.models.transformer import loss_fn

data = dict(np.load(sys.argv[1]))
batch = {k: jnp.asarray(data[f"batch0_{k}"]) for k in ("tokens", "labels")}
def tree(defs, prefix):
    if not isinstance(defs, dict):
        return jnp.asarray(data[prefix])
    return {k: tree(v, f"{prefix}/{k}") for k, v in defs.items()}
meta = {}
for case, _, _ in ranks.FAMILY_CASES:
    cfg = ranks.family_cfg(case, get_smoke_config)
    loss, m = jax.jit(lambda p, b: loss_fn(p, b, cfg))(tree(model_defs(cfg), f"p_{case}"),
                                                       batch)
    meta[case] = (float(loss), float(m["aux"]))
print("META", json.dumps(meta))
"""


def _inputs(path: str) -> None:
    """Every case's weights (numpy seed 0, the reference's init scales) and
    three batches of 4 x 32; the second masks most labels of the first
    data rank's rows."""
    d = {}
    for case in CASES:
        cfg = ranks.family_cfg(case, j_smoke)
        d.update(ranks.flatten(referee.numpy_params(j_model_defs(cfg), 0), f"p_{case}"))
    rng = np.random.default_rng(0)
    for s in range(3):
        for k in ("tokens", "labels"):
            d[f"batch{s}_{k}"] = rng.integers(0, 256, (4, 32)).astype(np.int32)
    d["batch1_labels"][:2, 5:] = -1
    np.savez(path, **d)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import json
    src = str(tmp_path_factory.mktemp("family_train") / "inputs.npz")
    _inputs(src)
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    ref = ranks.reference_run(textwrap.dedent(REFERENCE), [src], env, ROOT)
    port = ranks.spawn(ranks.family_train_cases, 4, src,
                       abort=ranks.reference_failed(ref))
    meta = json.loads(ranks.finish(ref).split("META ", 1)[1])
    return meta, port


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _blocks_close(grads: dict) -> None:
    assert grads
    for k, (got, want) in grads.items():
        assert got.shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("case", CASES)
def test_grad_blocks_are_one_devices(run, case):
    meta, port = run
    ref_loss, ref_aux = meta[case]
    for res in port:
        out = res[case]
        (one, mesh), (one_aux, aux) = out["loss"], out["aux"]
        assert _rel(mesh, one) <= 1e-4 and _rel(mesh, ref_loss) <= 1e-4
        assert abs(aux - one_aux) <= 1e-4 * max(one_aux, 1.0)
        assert abs(aux - ref_aux) <= 1e-4 * max(ref_aux, 1.0)
        assert (aux > 0) == ("mamba2" not in case)
        _blocks_close(out["grads"])


@pytest.mark.parametrize("case", ranks.FAMILY_AUX_ONLY)
def test_aux_only_grad_blocks_are_one_devices(run, case):
    """Every label -1: ce is 0 and aux alone drives the gradient, so the
    load-balance fractions' gradient is held by itself (its scale over the
    ``model`` and data ranks, ``moe._rank_fractions``)."""
    for res in run[1]:
        out = res[case]["aux_only"]
        assert out["ce"] == (0.0, 0.0)
        (one, mesh), (one_aux, aux) = out["loss"], out["aux"]
        assert one > 0 and _rel(mesh, one) <= 1e-4 and _rel(aux, one_aux) <= 1e-4
        _blocks_close(out["grads"])


@pytest.mark.parametrize("case", CASES)
def test_three_steps_match_one_device(run, case):
    for res in run[1]:
        steps, single, mesh = res[case]["steps"]
        for st in steps:
            for k, (one, got) in st.items():
                assert abs(got - one) <= 1e-4 * abs(one), (k, one, got)
        assert mesh.keys() == single.keys()
        for k, want in single.items():
            scale = max(float(np.abs(want).max()), LR if k.startswith("params/") else 0.0,
                        1e-30)
            err = float(np.abs(np.asarray(mesh[k], np.float64) - want).max())
            assert err <= 1e-5 * scale, (k, err, scale)


@pytest.mark.parametrize("case", MOE_CASES)
def test_expert_products_run_this_ranks_experts(run, case):
    from repro_torch.configs.base import get_smoke_config
    base = dict((c, a) for c, a, _ in ranks.FAMILY_CASES)[case]
    cfg = get_smoke_config(base)
    layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for res in run[1]:
        one, rank = res[case]["experts"]
        assert len(one) == len(rank) == 3 * layers
        assert all(s[0] == cfg.n_experts for s in one)
        assert [(cfg.n_experts // 2,) + s[1:] for s in one] == rank


def test_compressed_mamba2_matches_one_device(run):
    for res in run[1]:
        steps, single, mesh = res["mamba2_compressed"]
        assert any(k.startswith("ef/") for k in single)
        for st in steps:
            for k, (one, got) in st.items():
                assert abs(got - one) <= 1e-4 * abs(one), (k, one, got)
        for k, want in single.items():
            scale = max(float(np.abs(want).max()), 1e-30)
            off = int((np.abs(np.asarray(mesh[k], np.float64) - want) > 1e-4 * scale).sum())
            assert off <= max(1e-3 * want.size, 1), (k, off, want.size)


def test_capacity_one_directional_derivatives_match_finite_differences(run):
    for res in run[1]:
        assert len(res["fd"]) == ranks.FAMILY_FD_DIRECTIONS
        for ad, fd in res["fd"]:
            assert abs(ad - fd) <= 1e-6 * abs(fd), (ad, fd)


@pytest.mark.parametrize("case,words", [
    ("qwen3_moe", "n_experts=3 is not divisible by the 'model' mesh axis (size 2"),
    ("mamba2", "1 SSM heads and 160 conv channels do not both divide")])
def test_undivided_model_axis_raises_before_collectives(run, case, words):
    for res in run[1]:
        assert words in res["refused"][case], res["refused"][case]


class FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


@pytest.mark.parametrize("shape,spec,want", [
    ((2, 64, 296), (None, "data", "model"), [2]),   # 148 columns a rank
    ((2, 64, 256), (None, "data", "model"), []),    # 128: the blocks line up
    ((2, 8), (None, "model"), [1]),                 # 4 heads a rank, rows of 4
    ((2, 4, 64, 8), (None, "model", None, None), []),   # 64 x 8 a rank's expert
    ((64,), ("model",), [])])                       # 1-D: not compressed
def test_codec_sees_global_blocks(shape, spec, want):
    from repro_torch.launch import steps as St
    from repro_torch.models import sharding as shd
    mesh = FakeMesh(data=2, model=2)
    local = [n // shd.axis_size(mesh, e) for n, e in zip(shape, spec)]
    g = shd.place(torch.zeros(local), mesh, shd.P(*spec), shape)
    assert St._codec_dims(g, mesh) == want
