"""Step builders shared by the trainer, the server and the tests (twin of
the single-device half of ``repro.launch.steps``): one definition of the
train step, the plan, the prefill and decode steps, and the paged runtime's
lanes."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.apply import tree_leaves, tree_like
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.runtime import compression as gcomp

__all__ = ["make_train_step", "build_serving_plan", "make_prefill_step",
           "make_decode_step", "make_paged_decode_step",
           "make_chunked_prefill_step", "make_verify_step"]


def _value_and_grad(params, batch, cfg):
    """``(loss, metrics), grads`` of ``tfm.loss_fn`` at ``params``.  The
    gradients are taken through ``detach().requires_grad_()`` copies of the
    leaves, so the caller's tree is never marked; a leaf the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = tfm.loss_fn(tree_like(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_like(params, grads))


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, grad_compression: bool = False):
    """``(params, opt_state[, ef_state], batch) -> (params, opt_state[,
    ef_state], metrics)``: loss and gradients by autograd, MIP2Q gradient
    compression with error feedback when ``grad_compression``, then AdamW.
    Functional: new trees come back and the inputs are left as they were.
    ``metrics`` holds ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as
    tensors."""
    if grad_compression:
        def step(params, opt_state, ef_state, batch):
            (loss, metrics), grads = _value_and_grad(params, batch, cfg)
            grads, ef_state = gcomp.compress_tree_with_ef(grads, ef_state)
            params, opt_state, stats = adamw.adamw_update(opt_cfg, params, grads,
                                                          opt_state)
            return params, opt_state, ef_state, dict(metrics, loss=loss, **stats)
        return step

    def step(params, opt_state, batch):
        (loss, metrics), grads = _value_and_grad(params, batch, cfg)
        params, opt_state, stats = adamw.adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **stats)
    return step


def build_serving_plan(params, *, schedule=None, cfg=None, policy=None,
                       backend: Optional[str] = None, device="cuda"):
    """``(params, schedule | cfg | policy)`` ->
    :class:`repro_torch.engine.ExecutionPlan` on ``device``: the one place
    ``launch/serve``, ``serving.scheduler`` and the tests turn weights into a
    served plan."""
    from repro_torch import engine
    return engine.build_plan(params, schedule=schedule, cfg=cfg, policy=policy,
                             backend=backend, device=device)


def make_prefill_step(cfg, **kw):
    """(params, batch) -> (last-token logits, caches); ``kw`` (e.g.
    ``backend=``) reaches every linear."""
    def step(params, batch):
        return tfm.prefill(params, batch, cfg, **kw)
    return step


def make_decode_step(cfg, **kw):
    """(params, token, caches, cache_len) -> (logits, caches)."""
    def step(params, token, caches, cache_len):
        return tfm.decode_step(params, token, caches, cache_len, cfg, **kw)
    return step


def make_paged_decode_step(cfg, spec, cache_backend: Optional[str] = None, **kw):
    """Decode lane of the paged runtime: one (n_slots, 1) step over the page
    table.  ``spec`` (a :class:`repro_torch.engine.cache.CacheSpec`) rides
    the closure; ``kw`` reaches every linear."""
    def step(params, token, pools, hot, cache_len, page_table, active):
        return tfm.decode_step_paged(params, token, pools, hot, cache_len,
                                     page_table, active, spec, cfg,
                                     cache_backend=cache_backend, **kw)
    return step


def make_chunked_prefill_step(cfg, spec, cache_backend: Optional[str] = None, **kw):
    """Prefill lane: one fixed-shape (1, chunk) step that every slot's
    prompt advances through, chunk by chunk."""
    def step(params, tokens, pools, hot, page_table, slot, start, valid_len):
        return tfm.prefill_chunk_step(params, tokens, pools, hot, page_table,
                                      slot, start, valid_len, spec, cfg,
                                      cache_backend=cache_backend, **kw)
    return step


def make_verify_step(cfg, spec, cache_backend: Optional[str] = None, **kw):
    """Verify lane of self-speculative decoding: one fixed-shape (1, k+1)
    step that scores a slot's draft window at full fidelity and writes no
    cache state (the scheduler commits the accepted KV rows itself)."""
    def step(params, tokens, pools, hot, page_table, slot, start):
        return tfm.verify_chunk_step(params, tokens, pools, hot, page_table,
                                     slot, start, spec, cfg,
                                     cache_backend=cache_backend, **kw)
    return step
