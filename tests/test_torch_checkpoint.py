"""The port's checkpoints and fault-tolerant loop (``repro_torch.checkpoint``,
``repro_torch.runtime.fault_tolerance``), against the JAX reference's on
the CPU.

* Round trip: every dtype back bit for bit (bf16 through its uint16 bits),
  ``OptState`` and ``CompressionState`` leaves named as the reference names
  them, uncommitted and ``.tmp`` steps invisible, ``gc_keep``, a shape
  mismatch raising ``ValueError``, restore casting to the template's dtype.
* Cross-package: a train state the reference writes (bf16 and f32
  parameters, ``OptState``, the error-feedback state) restores in the port
  bit for bit, and the port's restores in the reference bit for bit; the
  manifests name the same leaves with the same shapes and dtypes.
* ``save_async`` snapshots the state before it returns and its ``join``
  re-raises a failed write; ``retry`` re-raises after ``max_tries``.
* Resume: six uninterrupted steps of ``TrainLoopRunner`` equal three, a
  restart through ``resume_or_init`` from the step-3 checkpoint, and three
  more, bit for bit (the data pipeline is indexed by step, the train step
  is functional).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.base import get_smoke_config as j_smoke
from repro.models import model_defs as j_model_defs
from repro.optim import adamw as jadamw
from repro.runtime import compression as jcomp
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.apply import _named_leaves
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model_defs
from repro_torch.models.params import init_params
from repro_torch.optim import adamw
from repro_torch.runtime import compression as comp
from repro_torch.runtime import fault_tolerance as ft

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each


def _state():
    """A small port train state: f32, bf16 and 1-D leaves, OptState, EF."""
    g = torch.Generator().manual_seed(0)
    params = {"blocks": {"pos0": {"w": torch.randn(2, 8, 16, generator=g)}},
              "embed": {"table": torch.randn(32, 8, generator=g).to(torch.bfloat16)},
              "norm": {"scale": torch.randn(8, generator=g)}}
    grads = {"blocks": {"pos0": {"w": torch.ones(2, 8, 16)}},
             "embed": {"table": torch.ones(32, 8)}, "norm": {"scale": torch.ones(8)}}
    params, opt, _ = adamw.adamw_update(adamw.AdamWConfig(), params, grads,
                                        adamw.init_opt_state(params))
    _, ef = comp.compress_tree_with_ef(grads, comp.init_ef_state(params))
    return {"params": params, "opt": opt, "ef": ef}


def _equal_trees(a, b):
    la, lb = list(_named_leaves(a)), list(_named_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_round_trip_names_and_commit_protocol(tmp_path):
    d = str(tmp_path / "ck")
    state = _state()
    ckpt.save(d, 5, state, extras={"note": "x"})
    with open(os.path.join(d, "step_000000005", "manifest.json")) as f:
        man = json.load(f)
    assert man["leaves"]["params/embed/table"] == {"shape": [32, 8], "dtype": "bfloat16"}
    assert man["leaves"]["opt/.step"] == {"shape": [], "dtype": "int32"}
    assert "opt/.m/blocks/pos0/w" in man["leaves"] and "ef/.residual/norm/scale" in man["leaves"]
    assert np.load(os.path.join(d, "step_000000005", "arrays.npz"))[
        "params/embed/table"].dtype == np.uint16
    # an uncommitted step and a .tmp are invisible
    os.makedirs(os.path.join(d, "step_000000009"))
    os.makedirs(os.path.join(d, "step_000000011.tmp"))
    assert ckpt.latest_step(d) == 5
    got, step, extras = ckpt.restore(d, state)
    assert step == 5 and extras == {"note": "x"}
    _equal_trees(got, state)
    assert isinstance(got["opt"], adamw.OptState) and isinstance(got["ef"], comp.CompressionState)
    # the template's dtype wins: bf16 bits restored into f32 exactly
    tmpl = dict(state, params=dict(state["params"], embed={
        "table": state["params"]["embed"]["table"].float()}))
    got32, _, _ = ckpt.restore(d, tmpl)
    assert torch.equal(got32["params"]["embed"]["table"],
                       state["params"]["embed"]["table"].float())
    bad = dict(state, params=dict(state["params"], norm={"scale": torch.zeros(9)}))
    with pytest.raises(ValueError, match="norm/scale"):
        ckpt.restore(d, bad)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), state)


def test_gc_keep(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, {"x": torch.full((2,), float(s))})
    os.makedirs(os.path.join(d, "step_000000007"))          # uncommitted
    ckpt.gc_keep(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_000000003", "step_000000004"]
    assert ckpt.latest_step(d) == 4


def test_save_async_snapshots_and_join_reraises(tmp_path, monkeypatch):
    x = torch.arange(6, dtype=torch.float32)
    t = ckpt.save_async(str(tmp_path), 1, {"x": x})
    x.add_(100)                     # the caller's tensor changes after the call
    t.join()
    got, _, _ = ckpt.restore(str(tmp_path), {"x": x})
    assert torch.equal(got["x"], torch.arange(6, dtype=torch.float32))

    def fail(*_):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "_write", fail)
    t = ckpt.save_async(str(tmp_path), 2, {"x": x})
    with pytest.raises(OSError, match="disk full"):
        t.join()


def test_retry_reraises_after_max_tries():
    calls = []

    def flaky():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")
    with pytest.raises(RuntimeError, match="CUDA error"):
        ft.retry(flaky, max_tries=3, backoff=0.0)
    assert len(calls) == 3
    seen = []

    def once():
        seen.append(1)
        if len(seen) == 1:
            raise RuntimeError("transient")
        return "ok"
    assert ft.retry(once, backoff=0.0) == "ok" and len(seen) == 2
    with pytest.raises(ValueError):     # not retriable: raised at once
        ft.retry(lambda: int("x"), backoff=0.0)


def test_heartbeat(tmp_path):
    hb = ft.Heartbeat(str(tmp_path), process_id=3)
    assert hb.last() is None and not hb.is_alive(10.0)
    hb.beat(7)
    assert hb.last()["step"] == 7 and hb.last()["process"] == 3 and hb.is_alive(10.0)


# ------------------------------------------------------- cross-package --

def _jax_state():
    jcfg = j_smoke("olmo_1b")
    p = referee.jax_params(j_model_defs(jcfg), 0)
    p["embed"]["table"] = p["embed"]["table"].astype(jnp.bfloat16)
    opt = jadamw.init_opt_state(p)
    g = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), p)
    p, opt, _ = jadamw.adamw_update(jadamw.AdamWConfig(), p, g, opt)
    _, ef = jcomp.compress_tree_with_ef(g, jcomp.init_ef_state(p))
    return {"params": p, "opt": opt, "ef": ef}


def _as_port(jstate):
    """The port's template of the same structure, dtypes and shapes."""
    def conv(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {"params": jax.tree.map(conv, jstate["params"]),
            "opt": adamw.OptState(conv(jstate["opt"].step),
                                  jax.tree.map(conv, jstate["opt"].m),
                                  jax.tree.map(conv, jstate["opt"].v)),
            "ef": comp.CompressionState(jax.tree.map(conv, jstate["ef"].residual))}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate = _jax_state()
    jckpt.save(str(tmp_path), 4, jstate)
    template = jax.tree.map(torch.zeros_like, _as_port(jstate))
    got, step, _ = ckpt.restore(str(tmp_path), template)
    assert step == 4 and int(got["opt"].step) == 1
    want = _as_port(jstate)
    _equal_trees(got, want)
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate = _jax_state()
    state = _as_port(jstate)
    ckpt.save(str(tmp_path / "port"), 4, state)
    jckpt.save(str(tmp_path / "ref"), 4, jstate)
    with open(tmp_path / "port" / "step_000000004" / "manifest.json") as f:
        mp = json.load(f)
    with open(tmp_path / "ref" / "step_000000004" / "manifest.json") as f:
        mr = json.load(f)
    assert mp == mr                                 # names, order, shapes, dtypes
    got, step, _ = jckpt.restore(str(tmp_path / "port"), jstate)
    assert step == 4
    for (n, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=str(n))


# --------------------------------------------------------------- resume --

def _runner_pieces(workdir):
    cfg = dataclasses.replace(t_smoke("olmo_1b"), remat=False)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    raw = make_train_step(cfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6))

    def step_fn(state, batch):
        p, o, m = raw(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    def init():
        p = init_params(model_defs(cfg), seed=0, device="cpu", dtype_override="float32")
        return {"params": p, "opt": adamw.init_opt_state(p)}
    runner = ft.TrainLoopRunner(str(workdir), ckpt_every=3)
    return runner, step_fn, init, lambda s: global_batch(dcfg, s, device="cpu")


def test_resume_is_bit_identical(tmp_path):
    runner, step_fn, init, batch_fn = _runner_pieces(tmp_path / "a")
    whole = runner.run(init(), 0, 6, step_fn, batch_fn, log_every=0)

    runner, step_fn, init, batch_fn = _runner_pieces(tmp_path / "b")
    runner.run(init(), 0, 3, step_fn, batch_fn, log_every=0)
    assert ckpt.latest_step(runner.ckpt_dir) == 3
    fresh = ft.TrainLoopRunner(str(tmp_path / "b"), ckpt_every=3)
    state, start = ft.resume_or_init(fresh.ckpt_dir, init(), init)
    assert start == 3 and int(state["opt"].step) == 3
    resumed = fresh.run(state, start, 6, step_fn, batch_fn, log_every=0)
    _equal_trees(resumed, whole)
    assert sorted(os.listdir(fresh.ckpt_dir)) == ["step_000000003", "step_000000006"]
    # a cold start when nothing is committed
    state, start = ft.resume_or_init(str(tmp_path / "none"), init(), init)
    assert start == 0


def test_loop_keeps_the_newest_checkpoints(tmp_path):
    runner, step_fn, init, batch_fn = _runner_pieces(tmp_path)
    runner.ckpt_every, runner.keep = 1, 2
    runner.run(init(), 0, 5, step_fn, batch_fn, log_every=0)
    assert sorted(os.listdir(runner.ckpt_dir)) == ["step_000000004", "step_000000005"]
    assert runner._pending is None          # every write joined
