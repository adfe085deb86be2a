"""The port's Mamba-2 mixer (``repro_torch.models.mamba2``): the SSD scan
against a float64 recurrence, chunk-size invariance and decode after
prefill (twins of tests/test_mamba2.py), then every function against the
JAX reference on the same seeded parameters (``params_from_numpy``):
``_ssd_chunked`` (with a carried state and a ragged last chunk),
``ssm_apply`` with its returned (conv tail, state), ``ssm_decode`` and
``ssm_prefill_chunk`` over 21 tokens in chunks of 8 (the last ragged, as in
tests/test_serving_runtime.py), each with the fused ``in_proj`` and with
``ssm_split_proj``.  Packed mixers run in tests/test_torch_models.py (the
whole Mamba-2 and Jamba smoke models under a mip2q plan).

Tolerance: rtol 2e-4, atol 2e-4 at f32, the reference's own for its scan
(test_mamba2.py); decode after prefill against the full forward keeps the
reference's 2e-3 for its step.  At bf16 activations the port keeps the
reference's casts, so its outputs differ from the reference's by rounding
only: within 2**-7 (one bf16 ulp) relative to the output's largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models import mamba2 as jm
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.models import mamba2 as tm
from repro_torch.models.params import params_from_numpy

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

TOL = dict(rtol=2e-4, atol=2e-4)
S, C = 21, 8                      # 2 full chunks + a ragged one (5 valid)


def _naive_recurrence(xh, dt, a, bb, cc):
    """h_t = h_{t-1}·exp(dt_t a) + dt_t x_t ⊗ B_t ;  y_t = C_t·h_t."""
    b, s, nh, hp = xh.shape
    ns = bb.shape[-1]
    h = np.zeros((b, nh, hp, ns), np.float64)
    ys = []
    xh, dt, a, bb, cc = (np.asarray(t, np.float64) for t in (xh, dt, a, bb, cc))
    for t in range(s):
        decay = np.exp(dt[:, t] * a[None, :])
        inp = np.einsum("bk,bhp,bh->bhpk", bb[:, t], xh[:, t], dt[:, t])
        h = h * decay[:, :, None, None] + inp
        ys.append(np.einsum("bk,bhpk->bhp", cc[:, t], h))
    return np.stack(ys, axis=1), h


def _scan_inputs(seed, b, s, nh, hp, ns, dt_hi=0.5, a_hi=1.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, nh, hp)).astype(np.float32),
            rng.uniform(0.01, dt_hi, size=(b, s, nh)).astype(np.float32),
            -rng.uniform(0.2, a_hi, size=(nh,)).astype(np.float32),
            rng.normal(size=(b, s, ns)).astype(np.float32),
            rng.normal(size=(b, s, ns)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_ssd_chunked_matches_recurrence():
    xh, dt, a, bb, cc = _scan_inputs(0, 2, 32, 3, 4, 8)
    y, h_t = tm._ssd_chunked(*_t(xh, dt, a, bb, cc), chunk=8)
    y_ref, h_ref = _naive_recurrence(xh, dt, a, bb, cc)
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    np.testing.assert_allclose(h_t.numpy(), h_ref, **TOL)


def test_ssd_chunk_size_invariance():
    args = _t(*_scan_inputs(1, 1, 64, 2, 4, 4, dt_hi=0.3, a_hi=1.0))
    y8, h8 = tm._ssd_chunked(*args, chunk=8)
    y64, h64 = tm._ssd_chunked(*args, chunk=64)
    np.testing.assert_allclose(y8.numpy(), y64.numpy(), **TOL)
    np.testing.assert_allclose(h8.numpy(), h64.numpy(), **TOL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (21, 8), (5, 256)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Ragged tails and a carried initial state, against the reference."""
    xh, dt, a, bb, cc = _scan_inputs(2, 2, s, 3, 4, 8)
    h0 = np.random.default_rng(3).normal(size=(2, 3, 4, 8)).astype(np.float32)
    y, h_t = tm._ssd_chunked(*_t(xh, dt, a, bb, cc), chunk=chunk,
                             h0=torch.from_numpy(h0))
    jy, jh = jm._ssd_chunked(*map(jnp.asarray, (xh, dt, a, bb, cc)), chunk,
                             h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh), **TOL)


def _cfgs(split: bool, dtype="float32"):
    over = dict(dtype=dtype, ssm_split_proj=split)
    return (dataclasses.replace(j_smoke("mamba2_780m"), **over),
            dataclasses.replace(t_smoke("mamba2_780m"), **over))


def _params(jcfg, seed=0):
    """One mixer's params, seeded, with the zero / one inits replaced by
    draws so every head has its own a, dt bias, skip and norm scale."""
    p = jax.tree.map(np.asarray, referee.jax_params(jm.ssm_def(jcfg), seed))
    rng = np.random.default_rng(seed + 100)
    for name, lo, hi in (("a_log", -1.0, 1.0), ("dt_bias", -2.0, 0.5),
                         ("d_skip", 0.5, 1.5), ("norm_scale", 0.5, 1.5),
                         ("conv_b", -0.1, 0.1)):
        p[name] = rng.uniform(lo, hi, size=p[name].shape).astype(np.float32)
    return p


def _x(shape, seed=0, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(dtype)


def test_ssm_decode_matches_full_forward():
    """The port alone: ssm_apply on s + 1 tokens == prefill(s) + one decode
    step (the reference's tolerances)."""
    _, tcfg = _cfgs(False)
    p = params_from_numpy(_params(_cfgs(False)[0]), device="cpu")
    x = torch.from_numpy(_x((2, 17, tcfg.d_model), seed=2) * 0.2)
    full = tm.ssm_apply(p, x, tcfg, chunk=8)
    prefix, cache = tm.ssm_apply(p, x[:, :16], tcfg, chunk=8, return_state=True)
    step, _ = tm.ssm_decode(p, x[:, 16:17], tcfg, cache)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 16].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(prefix.numpy(), full[:, :16].numpy(), **TOL)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_ssm_apply_matches_reference(split):
    jcfg, tcfg = _cfgs(split)
    p = _params(jcfg)
    x = _x((2, S, tcfg.d_model), seed=4)
    jout, (jconv, jh) = jm.ssm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                     jcfg, chunk=C, return_state=True)
    out, (conv, h) = tm.ssm_apply(params_from_numpy(p, device="cpu"),
                                  torch.from_numpy(x), tcfg, chunk=C,
                                  return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_ssm_decode_matches_reference(split):
    jcfg, tcfg = _cfgs(split)
    p = _params(jcfg, seed=1)
    di, nh, hp, ns, conv_dim = tm._dims(tcfg)
    rng = np.random.default_rng(5)
    x = _x((3, 1, tcfg.d_model), seed=6)
    conv = rng.normal(size=(3, tcfg.ssm_conv - 1, conv_dim)).astype(np.float32)
    h = rng.normal(size=(3, nh, hp, ns)).astype(np.float32)
    jout, (jconv, jh) = jm.ssm_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                      jcfg, (jnp.asarray(conv), jnp.asarray(h)))
    out, (nconv, nh_) = tm.ssm_decode(params_from_numpy(p, device="cpu"),
                                      torch.from_numpy(x), tcfg,
                                      tuple(_t(conv, h)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(nconv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(nh_.numpy(), np.asarray(jh), **TOL)


def _chunked(mod, p, x, cfg, as_arr, zeros, valid):
    """ssm_prefill_chunk over x (1, S, D) in chunks of C from a zero cache;
    returns (outputs over the valid rows, conv, state)."""
    di, nh, hp, ns, conv_dim = mod._dims(cfg)
    conv = zeros((1, cfg.ssm_conv - 1, conv_dim))
    h = zeros((1, nh, hp, ns))
    outs = []
    for start in range(0, x.shape[1], C):
        n = min(C, x.shape[1] - start)
        xc = np.zeros((1, C, x.shape[2]), x.dtype)
        xc[:, :n] = x[:, start:start + n]
        y, (conv, h) = mod.ssm_prefill_chunk(p, as_arr(xc), cfg, (conv, h), valid(n))
        outs.append(np.asarray(y)[:, :n])
    return np.concatenate(outs, axis=1), np.asarray(conv), np.asarray(h)


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
def test_ssm_prefill_chunk_matches_reference_and_one_shot(split):
    """21 tokens in chunks of 8 (a ragged last chunk of 5) carried through
    ``ssm_prefill_chunk``: equal to the reference's chunks and to the port's
    one-shot ``ssm_apply`` (outputs, conv tail, state)."""
    jcfg, tcfg = _cfgs(split)
    p = _params(jcfg, seed=2)
    x = _x((1, S, tcfg.d_model), seed=7)
    tp = params_from_numpy(p, device="cpu")
    got = _chunked(tm, tp, x, tcfg, torch.from_numpy,
                   lambda s: torch.zeros(s, dtype=torch.float32),
                   lambda n: torch.tensor(n, dtype=torch.int32))
    want = _chunked(jm, jax.tree.map(jnp.asarray, p), x, jcfg, jnp.asarray,
                    lambda s: jnp.zeros(s, jnp.float32), jnp.int32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    out, (conv, h) = tm.ssm_apply(tp, torch.from_numpy(x), tcfg, return_state=True)
    for g, w in zip(got, (out, conv, h)):
        np.testing.assert_allclose(g, w.numpy(), **TOL)


def test_short_prompt_conv_tail_is_left_padded():
    """A prompt shorter than the conv window: the tail is the prompt's rows
    behind zeros (the inputs before the start), so decode continues as the
    one-shot forward does."""
    jcfg, tcfg = _cfgs(False)
    p = params_from_numpy(_params(jcfg, seed=3), device="cpu")
    x = torch.from_numpy(_x((2, 4, tcfg.d_model), seed=8))
    full = tm.ssm_apply(p, x, tcfg)
    _, cache = tm.ssm_apply(p, x[:, :2], tcfg, return_state=True)
    assert cache[0].shape == (2, tcfg.ssm_conv - 1, tm._dims(tcfg)[-1])
    assert not cache[0][:, 0].any()
    for i in (2, 3):
        y, cache = tm.ssm_decode(p, x[:, i:i + 1], tcfg, cache)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, i].numpy(), **TOL)


def test_ssm_apply_bf16_keeps_the_reference_casts():
    """bf16 activations: outputs, conv tail (bf16) and state (f32) within one
    bf16 ulp of the reference's, relative to each one's largest value."""
    jcfg, tcfg = _cfgs(False, dtype="bfloat16")
    p = _params(jcfg, seed=4)
    x = _x((2, S, tcfg.d_model), seed=9)
    jout, (jconv, jh) = jm.ssm_apply(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x, jnp.bfloat16), jcfg, chunk=C,
                                     return_state=True)
    out, (conv, h) = tm.ssm_apply(params_from_numpy(p, device="cpu"),
                                  torch.from_numpy(x).to(torch.bfloat16), tcfg,
                                  chunk=C, return_state=True)
    assert out.dtype == conv.dtype == torch.bfloat16 and h.dtype == torch.float32
    for got, want in ((out, jout), (conv, jconv), (h, jh)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 2 ** -7 * np.abs(want).max(), err


def test_scan_gradient_is_finite_under_exp_overflow():
    """Large ``dt · |a|`` makes ``seg`` above the diagonal overflow ``exp``
    in f32.  Masking ``seg`` before ``exp`` gives the same decay bits as
    selecting after it (which puts 0 · inf = NaN into the gradient of
    ``seg``), the scan still matches the float64 recurrence, and every
    gradient is finite."""
    xh, dt, a, bb, cc = _scan_inputs(7, 2, 32, 2, 4, 8, dt_hi=10.0, a_hi=20.0)
    c = 16
    cum = torch.cumsum(torch.from_numpy(dt[:, :c] * a[None, None, :]), dim=1)
    seg = (cum[:, :, None, :] - cum[:, None, :, :]).requires_grad_()
    tril = torch.ones((c, c), dtype=torch.bool).tril()
    assert torch.isinf(torch.exp(seg)).any()        # the overflow is real
    new = tm._segment_decay(seg, tril)
    old = torch.where(tril[None, :, :, None], torch.exp(seg), torch.zeros(()))
    assert torch.equal(new, old)
    g_new, = torch.autograd.grad(new.sum(), seg)
    g_old, = torch.autograd.grad(old.sum(), seg)
    assert torch.isfinite(g_new).all() and torch.isnan(g_old).any()

    ins = [t.requires_grad_() for t in _t(xh, dt, a, bb, cc)]
    y, h = tm._ssd_chunked(*ins, chunk=c)
    y_ref, h_ref = _naive_recurrence(xh, dt, a, bb, cc)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, **TOL)
    np.testing.assert_allclose(h.detach().numpy(), h_ref, **TOL)
    grads = torch.autograd.grad(y.sum() + h.sum(), ins)
    for name, g in zip(("xh", "dt", "a", "bb", "cc"), grads):
        assert torch.isfinite(g).all(), name
