"""The port's serving slice vs the JAX reference on smoke models.

Reference params (seeded, f32) carry across to the port through numpy; a
packed plan's payloads carry across the other way, so both sides run the
same weights and the same packed bytes (payload identity itself is held in
test_torch_engine.py).  ``olmo_1b`` (non-parametric LN, tied head, MHA) and
``qwen2_7b`` (GQA with kv-major heads, QKV bias, RMSNorm) each run dense
and under mip2q p = 0.5, dliq p = 1.0 and p = 0 plans; the other eight
configs of ``ARCH_IDS`` (DeepSeek, StableLM, InternVL2, MusicGen with its
plain-GELU MLP, the two MoE configs, Mamba-2 and the Jamba hybrid) dense
and under mip2q p = 0.5; the stub-frontend configs (``vlm``, ``audio``)
also through ``embeds`` (prompt and teacher-forced decode inputs as
embeddings).  All at f32 activations.

Tolerance: dense and MoE logits agree to rtol 1e-4, atol 1e-5 (f32
products summed in different orders by XLA and ATen); the ``ssm`` and
``hybrid`` families to rtol 2e-4, atol 2e-4, the reference's own tolerance
for its chunked scan (the SSD sums run in another order and across chunk
boundaries in both packages).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.policy import StruMConfig as JCfg
from repro.launch.serve import pad_caches as j_pad_caches
from repro.launch.serve import serve as j_serve
from repro.models import decode_step as j_decode_step
from repro.models import forward_train as j_forward
from repro.models import model_defs as j_model_defs
from repro.models import prefill as j_prefill
from repro.models.layers import linear as j_linear
from repro_torch import engine
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.launch.serve import pad_caches, serve
from repro_torch.models import decode_step, forward_train, prefill
from repro_torch.models.layers import linear
from repro_torch.models.params import params_from_numpy

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

RTOL, ATOL = 1e-4, 1e-5
SSM_TOL = dict(rtol=2e-4, atol=2e-4)
FIELDS = ("mask", "hi", "lo", "scale")
PLANS = {"dense": None, "mip2q_p0.5": dict(method="mip2q", p=0.5, L=5),
         "dliq_p1.0": dict(method="dliq", p=1.0, q=4),
         "dliq_p0": dict(method="dliq", p=0.0, q=4)}
B, PROMPT, STEPS, SEQ = 2, 8, 3, 40   # SEQ > attn_chunk (32): a ragged tail
ALL_PLANS = ("olmo_1b", "qwen2_7b")   # every plan; the rest dense and mip2q
ZOO = [a for a in ARCH_IDS if a not in ALL_PLANS]
CASES = [(a, p) for a in ALL_PLANS for p in PLANS] + \
    [(a, p) for a in ZOO for p in ("dense", "mip2q_p0.5")]
EMBEDS = [a for a in ARCH_IDS if t_smoke(a).modality in ("vlm", "audio")]


def _cfgs(arch, accum="float32"):
    return (dataclasses.replace(j_smoke(arch), dtype="float32", accum_dtype=accum),
            dataclasses.replace(t_smoke(arch), dtype="float32", accum_dtype=accum))


def _tol(cfg) -> dict:
    if cfg.family in ("ssm", "hybrid"):
        return SSM_TOL
    return dict(rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _arch_params(arch):
    jcfg, _ = _cfgs(arch)
    jparams = referee.jax_params(j_model_defs(jcfg), 0)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _set(tree, name, leaf):
    keys = name.split("/")
    for k in keys[:-1]:
        tree = tree[k]
    tree[keys[-1]] = leaf


def _served(jparams, tparams, plan_kw):
    """(reference served tree, port served tree, port plan) for one plan."""
    if plan_kw is None:
        return jparams, tparams, None
    tplan = engine.build_plan(tparams, cfg=TCfg(**plan_kw), device="cpu")
    jplan = jengine.build_plan(jparams, cfg=JCfg(**plan_kw), pack=False)
    jserved = jax.tree.map(lambda a: a, jparams)
    for name, entry in jplan.entries.items():
        leaf = {f: jnp.asarray(tplan[name].leaf[f].numpy()) for f in FIELDS}
        _set(jserved, name, dict(leaf, cfg=entry.cfg, spec=entry.spec))
    return jserved, tplan.params, tplan


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


def _held_to_reference(arch, plan, embeds=False, accum="float32"):
    """forward_train over SEQ inputs, then prefill over PROMPT and STEPS
    teacher-forced decode steps, both packages on the same served weights;
    ``embeds``: every input an embedding (B, ., D) instead of a token id;
    ``accum``: both configs' ``accum_dtype``."""
    jcfg, tcfg = _cfgs(arch, accum)
    jparams, tparams = _arch_params(arch)
    jserved, tserved, tplan = _served(jparams, tparams, PLANS[plan])
    if tplan is not None:   # CPU tensors: the torch family
        assert set(tplan.variants().values()) == {"torch:dequant"}
    if embeds:
        rng = np.random.default_rng(3)
        seq = rng.normal(size=(B, SEQ, tcfg.d_model)).astype(np.float32)
        key, as_torch = "embeds", torch.from_numpy
    else:
        seq = _tokens(1, (B, SEQ))
        key, as_torch = "tokens", lambda a: torch.from_numpy(a).long()
    prompt, teach = seq[:, :PROMPT], seq[:, PROMPT:PROMPT + STEPS]

    def reference(params, seq, prompt, teach):
        full, _ = j_forward(params, {key: seq}, jcfg)
        lg, caches = j_prefill(params, {key: prompt}, jcfg)
        caches = j_pad_caches(caches, STEPS)
        steps = [lg[:, -1]]
        for i in range(STEPS):
            lg, caches = j_decode_step(params, teach[:, i:i + 1], caches,
                                       jnp.int32(PROMPT + i), jcfg)
            steps.append(lg[:, -1])
        return full, jnp.stack(steps, axis=1)
    j_full, j_steps = jax.jit(reference)(jserved, seq, prompt, teach)

    t_full, _ = forward_train(tserved, {key: as_torch(seq)}, tcfg)
    lg, caches = prefill(tserved, {key: as_torch(prompt)}, tcfg)
    caches = pad_caches(caches, STEPS)
    t_steps = [lg[:, -1]]
    for i in range(STEPS):
        lg, caches = decode_step(tserved, as_torch(teach[:, i:i + 1]), caches,
                                 PROMPT + i, tcfg)
        t_steps.append(lg[:, -1])
    tol = _tol(tcfg)
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full), **tol)
    np.testing.assert_allclose(torch.stack(t_steps, 1).numpy(), np.asarray(j_steps),
                               **tol)
    # decode through the cache == the full forward at the same positions
    np.testing.assert_allclose(torch.stack(t_steps, 1).numpy(),
                               t_full[:, PROMPT - 1:PROMPT + STEPS].numpy(), **tol)


@pytest.mark.parametrize("arch,plan", CASES, ids=[f"{a}-{p}" for a, p in CASES])
def test_logits_match_reference(arch, plan):
    _held_to_reference(arch, plan)


@pytest.mark.parametrize("plan", ["dense", "mip2q_p0.5"])
def test_accum_dtype_default_matches_reference(plan):
    """``cfg.accum_dtype`` at its default (f32) through the whole serving
    slice: the logits at the tolerance above."""
    _held_to_reference("qwen2_7b", plan, accum="float32")


def _group0(leaf):
    """Layer group 0 of a stacked dense weight or packed leaf."""
    if isinstance(leaf, dict):
        return {k: (v[0] if k in FIELDS else v) for k, v in leaf.items()}
    return leaf[0]


@pytest.mark.parametrize("name", ["wi", "wo"])
@pytest.mark.parametrize("plan", ["dense", "mip2q_p0.5"])
def test_accum_dtype_bf16_linear_matches_reference(plan, name):
    """At ``accum_dtype="bfloat16"`` a linear rounds its f32 product to
    bf16 before x's dtype (dense, and the ``torch:dequant`` route of a
    packed leaf), as the reference's ``preferred_element_type`` does: one
    MLP linear of the qwen2_7b smoke model on f32 activations, against the
    reference's ``linear``, every output within one bf16 step and 99% of
    them bit-identical (measured: all).  The setting acts: its outputs are
    not the f32 ones.  Through the whole model the two packages' f32 sums
    in other orders (attention, norms) make a product round to the
    neighbouring bf16 value now and then, in a way that changes from
    process to process (CPU XLA's threads), so the logits are held at the
    default ``accum_dtype`` only (above)."""
    jparams, tparams = _arch_params("qwen2_7b")
    jserved, tserved, _ = _served(jparams, tparams, PLANS[plan])
    jl = {"w": _group0(jserved["blocks"]["pos0"]["mlp"][name]["w"])}
    tl = {"w": _group0(tserved["blocks"]["pos0"]["mlp"][name]["w"])}
    k_dim = int(jparams["blocks"]["pos0"]["mlp"][name]["w"].shape[-2])
    x = np.random.default_rng(0).normal(size=(B * SEQ, k_dim)).astype(np.float32)
    want = np.asarray(j_linear(jl, jnp.asarray(x), accum_dtype=jnp.bfloat16))
    got = linear(tl, torch.from_numpy(x), accum_dtype="bfloat16").numpy()
    f32 = linear(tl, torch.from_numpy(x)).numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()
    assert (got == want).mean() >= 0.99
    assert (got != f32).mean() >= 0.9


@pytest.mark.parametrize("arch", EMBEDS)
@pytest.mark.parametrize("plan", ["dense", "mip2q_p0.5"])
def test_embeds_match_reference(arch, plan):
    """The audio / VLM stub frontend: ``batch["embeds"]`` into prefill and
    forward_train, (B, 1, D) embeddings into every decode step."""
    _held_to_reference(arch, plan, embeds=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_greedy_tokens_teacher_forced_against_reference_serve(arch):
    """Greedy tokens of ``repro.launch.serve.serve`` are compared position by
    position, teacher-forced, with the port's predictions (raw greedy
    suffixes diverge after one near-tied flip); a disagreement is allowed
    only where the two tokens' logits are within 1e-4 (a near tie)."""
    jparams, tparams = _arch_params(arch)
    jcfg, tcfg = _cfgs(arch)
    kw = PLANS["mip2q_p0.5"]
    jserved, tserved, _ = _served(jparams, tparams, kw)
    prompt = _tokens(2, (B, PROMPT))
    gen = 6
    j_toks, _, _ = j_serve(dataclasses.replace(jcfg, strum=JCfg(**kw)), jserved,
                           jnp.asarray(prompt), gen, {})
    j_toks = np.asarray(j_toks)
    seq = np.concatenate([prompt, j_toks[:, :gen]], axis=1)
    lg, _ = forward_train(tserved, {"tokens": torch.from_numpy(seq).long()}, tcfg)
    lg = lg[:, PROMPT - 1:, :tcfg.vocab_size].numpy()
    pred = lg.argmax(-1)
    for b, t in zip(*np.nonzero(pred != j_toks)):
        assert lg[b, t, pred[b, t]] - lg[b, t, j_toks[b, t]] < 1e-4, (b, t)
    # the port's own serve loop agrees with its teacher-forced forward
    toks, _, _ = serve(dataclasses.replace(tcfg, strum=TCfg(**kw)), tserved,
                       torch.from_numpy(prompt).long(), gen, device="cpu")
    seq = torch.cat([torch.from_numpy(prompt).long(), toks[:, :gen]], dim=1)
    lg, _ = forward_train(tserved, {"tokens": seq}, tcfg)
    assert torch.equal(lg[:, PROMPT - 1:, :tcfg.vocab_size].argmax(-1), toks)
