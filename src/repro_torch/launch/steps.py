"""Step builders shared by the trainer, the server and the tests (twin of
``repro.launch.steps``): one definition of the train step (single-device;
on a mesh the reference's train layout for every family, with the ZeRO-3
step kept beside it as a yardstick), the plan, the prefill and decode
steps, and the paged runtime's lanes, each with the reference's
``mesh=`` / ``rules=``."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.apply import tree_leaves, tree_like
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import Rules, rules_for_mesh
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


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh=None,
                    rules: Optional[Rules] = None, grad_compression: bool = False):
    """``(params, opt_state[, ef_state], batch) -> (params, opt_state[,
    ef_state], metrics)``: loss and gradients by autograd, MIP2Q gradient
    compression with error feedback when ``grad_compression``, then AdamW.
    Functional: new trees come back and the inputs are left as they were.
    ``metrics`` holds ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as
    tensors.  With ``mesh`` every family's step runs the train layout of
    ``models.transformer`` (:func:`_tp_step`); :func:`_zero3_step` is not
    selected."""
    if mesh is not None:
        return _tp_step(cfg, opt_cfg, mesh, rules or rules_for_mesh(mesh),
                        grad_compression)
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


def _zero3_value_and_grad(params, batch, cfg, mesh, rules: Rules, defs):
    """``(loss, metrics), grads`` of the whole ``batch`` from this rank's
    parameter shards: gather the full parameters, take the loss of this
    rank's rows (the batch splits over the rules' ``batch`` axes), and
    all-reduce the gradients (mean), each rank's weighted by its share of
    the labelled tokens, so loss and gradients are the whole batch's, as on
    one device.  MoE layers route over the whole batch (capacity, slots and
    the load-balance fractions: ``moe.moe_apply(batch_split=)``), so their
    aux is the single-device one on every rank.  ``grads`` is the full
    gradient tree, on every rank."""
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import gather_params
    axes = rules.table.get("batch")
    full = gather_params(params, defs, mesh, rules)
    local = {k: shd.shard_slice(v, shd.P(axes), mesh) for k, v in batch.items()}
    leaves = [p.detach().requires_grad_() for p in tree_leaves(full)]
    _, m = tfm.loss_fn(tree_like(full, leaves), local, cfg, batch_split=(mesh, axes))
    n = (local["labels"] >= 0).sum().to(torch.float32)
    share = n * shd.axis_size(mesh, axes) / torch.clamp(
        shd.all_reduce(n, mesh, axes), min=1.0)
    obj = share * m["ce"] + cfg.router_aux_weight * m["aux"]
    grads = torch.autograd.grad(obj, leaves, materialize_grads=True)
    grads = tree_like(full, [shd.all_reduce(g, mesh, axes, "mean") for g in grads])
    ce = shd.all_reduce(share * m["ce"].detach(), mesh, axes, "mean")
    aux = m["aux"].detach()                       # the whole batch's already
    return (ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}), grads


def _zero3_step(cfg, opt_cfg: adamw.AdamWConfig, mesh, rules: Rules,
                grad_compression: bool):
    """A yardstick beside :func:`_tp_step`, which ``make_train_step``
    selects on a mesh: the train step ZeRO-3 over the data axes, routing an
    MoE layer over the whole batch as one device does.  ``params``, the
    AdamW moments (and the error-feedback residual) are this rank's shards
    under ``rules`` (``models.params.shard_params``); ``batch`` is global.
    Loss and gradients come from :func:`_zero3_value_and_grad`; the clip
    reads the reduced gradients' global norm; AdamW updates each rank's
    shards.  Dense compute is replicated over the ``model`` axis (no
    tensor-parallel train step)."""
    from repro_torch.models import model_defs
    from repro_torch.models.params import gather_params, shard_params
    defs = model_defs(cfg)

    def update(params, opt_state, grads, loss, metrics):
        params, opt_state, stats = adamw.adamw_update(
            opt_cfg, params, shard_params(grads, defs, mesh, rules), opt_state,
            gnorm=adamw.global_norm(grads))
        return params, opt_state, dict(metrics, loss=loss, **stats)

    if grad_compression:
        def step(params, opt_state, ef_state, batch):
            (loss, metrics), grads = _zero3_value_and_grad(params, batch, cfg, mesh,
                                                           rules, defs)
            res = gather_params(ef_state.residual, defs, mesh, rules)
            grads, ef = gcomp.compress_tree_with_ef(grads, gcomp.CompressionState(res))
            params, opt_state, metrics = update(params, opt_state, grads, loss, metrics)
            ef_state = gcomp.CompressionState(shard_params(ef.residual, defs, mesh,
                                                           rules))
            return params, opt_state, ef_state, metrics
        return step

    def step(params, opt_state, batch):
        (loss, metrics), grads = _zero3_value_and_grad(params, batch, cfg, mesh,
                                                       rules, defs)
        return update(params, opt_state, grads, loss, metrics)
    return step


def _held_as(tree, like):
    """``tree``'s leaves carrying the placements of ``like``'s (the same
    blocks of the same tensors: gradients, updated parameters)."""
    from repro_torch.models import sharding as shd

    def hold(t, ref):
        t = t.view_as(t)
        t._placement = shd.placement(ref)
        return t
    return tree_like(like, [hold(t, ref) for t, ref in zip(tree_leaves(tree),
                                                            tree_leaves(like))])


def _tp_value_and_grad(params, batch, cfg, mesh, rules: Rules):
    """``(loss, metrics), grads`` of the whole ``batch`` in the train
    layout: ``params`` are this rank's placed shards and so are the
    gradients.  Each rank takes the loss of its rows (the batch
    splits over the rules' ``batch`` axes), weighted by its share of the
    labelled tokens and divided by the data ranks' count, so the sum over
    the data ranks is the whole batch's loss; the gradient of a leaf split
    over the data axes is that sum already (the FSDP gather's backward),
    the gradient of one replicated over them is all-reduced here.  No
    parameter is gathered whole: each is gathered over its ``embed`` axes
    per use."""
    from repro_torch.models import sharding as shd
    axes = rules.table.get("batch")
    n_data = shd.axis_size(mesh, axes)
    local = {k: shd.shard_slice(v, shd.P(axes), mesh) for k, v in batch.items()}
    held = tree_leaves(params)
    leaves = [p.detach().requires_grad_() for p in held]
    for leaf, p in zip(leaves, held):
        leaf._placement = shd.placement(p)
    _, m = tfm.loss_fn(tree_like(params, leaves), local, cfg, mesh=mesh, rules=rules)
    n = (local["labels"] >= 0).sum().to(torch.float32)
    share = n * n_data / torch.clamp(shd.all_reduce(n, mesh, axes), min=1.0)
    obj = (share * m["ce"] + cfg.router_aux_weight * m["aux"]) / n_data
    grads = list(torch.autograd.grad(obj, leaves, materialize_grads=True))
    data = set(shd._as_axes(axes))
    # one leaf's sum alive at a time; a leaf split over the data axes is
    # summed over them by its gather's backward already
    for i, p in enumerate(held):
        spec = shd.placement(p).spec
        if not data & {a for e in spec for a in shd._as_axes(e)}:
            grads[i] = shd.all_reduce(grads[i], mesh, axes)
    ce = shd.all_reduce(share * m["ce"].detach(), mesh, axes, "mean")
    aux = m["aux"].detach()
    return ((ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}),
            _held_as(tree_like(params, grads), params))


def _tp_step(cfg, opt_cfg: adamw.AdamWConfig, mesh, rules: Rules,
             grad_compression: bool):
    """Every family's train step on a mesh, the reference's train
    ``input_shardings``: ``params``, the AdamW moments (and the
    error-feedback residual) are this rank's shards under ``rules``
    (``models.params.shard_params``); ``batch`` is global and each rank
    takes its rows.  Loss and gradients from :func:`_tp_value_and_grad`;
    the clip reads the global norm of the sharded gradients
    (``adamw.global_norm(mesh=)``); AdamW updates each rank's shards, which
    keep their placements.  Under compression the codec sees the global
    ``[1, w]`` blocks (:func:`_compress_placed`)."""
    def update(params, opt_state, grads, loss, metrics):
        new, opt_state, stats = adamw.adamw_update(
            opt_cfg, params, grads, opt_state, gnorm=adamw.global_norm(grads, mesh))
        return _held_as(new, params), opt_state, dict(metrics, loss=loss, **stats)

    if grad_compression:
        def step(params, opt_state, ef_state, batch):
            (loss, metrics), grads = _tp_value_and_grad(params, batch, cfg, mesh, rules)
            dec, ef_state = _compress_placed(grads, ef_state, mesh)
            params, opt_state, metrics = update(params, opt_state,
                                                _held_as(dec, params), loss, metrics)
            return params, opt_state, ef_state, metrics
        return step

    def step(params, opt_state, batch):
        (loss, metrics), grads = _tp_value_and_grad(params, batch, cfg, mesh, rules)
        return update(params, opt_state, grads, loss, metrics)
    return step


#: the gradient codec's block width (``runtime.compression``'s default)
_CODEC_W = 16


def _codec_dims(g: torch.Tensor, mesh) -> list:
    """The dims of a placed gradient block the codec must see whole for
    its ``[1, w]`` blocks of the flattened tensor to be the global
    tensor's: from the last split dim back, each one whose local rows
    (``prod(shape[k:])``, the dims after it whole) are no multiple of
    ``w``.  Past the last split dim every run of a block's elements starts
    at a multiple of that product in the global order, so once it is a
    multiple of ``w`` the blocks line up."""
    from repro_torch.models import sharding as shd
    pl = shd.placement(g)
    if pl is None or g.dim() < 2:
        return []
    shape, dims = list(g.shape), []
    for k in reversed([k for k, e in enumerate(pl.spec) if shd.axis_size(mesh, e) > 1]):
        if math.prod(shape[k:]) % _CODEC_W == 0:
            break
        dims.append(k)
        shape[k] = pl.shape[k]
    return dims


def _compress_placed(grads, ef_state, mesh):
    """``compress_tree_with_ef`` on this rank's gradient blocks as the
    reference's codec runs on the global arrays: a leaf whose blocks would
    not line up with the global tensor's (:func:`_codec_dims`; Mamba-2's
    ``in_proj`` at 3224 columns a rank) is gathered with its residual over
    those dims around the codec and cut back to this rank's block."""
    from repro_torch.models import sharding as shd
    gl, rl = tree_leaves(grads), tree_leaves(ef_state.residual)
    cuts = [[(k, shd.placement(g).spec[k]) for k in _codec_dims(g, mesh)] for g in gl]

    def whole(t, cut):
        for k, entry in cut:
            t = shd.all_gather(t, mesh, entry, k)
        return t

    def block(t, cut):
        for k, entry in cut:
            t = t.chunk(shd.axis_size(mesh, entry), dim=k)[shd.axis_index(mesh, entry)]
        return t.contiguous()
    dec, ef = gcomp.compress_tree_with_ef(
        tree_like(grads, [whole(g, c) for g, c in zip(gl, cuts)]),
        gcomp.CompressionState(tree_like(ef_state.residual,
                                         [whole(r, c) for r, c in zip(rl, cuts)])),
        w=_CODEC_W)
    return (tree_like(grads, [block(t, c) for t, c in zip(tree_leaves(dec), cuts)]),
            gcomp.CompressionState(tree_like(ef_state.residual, [
                block(t, c) for t, c in zip(tree_leaves(ef.residual), cuts)])))


def build_serving_plan(params, *, schedule=None, cfg=None, policy=None,
                       backend: Optional[str] = None, mesh=None,
                       rules: Optional[Rules] = None, device="cuda"):
    """``(params, schedule | cfg | policy)`` ->
    :class:`repro_torch.engine.ExecutionPlan` on ``device``: the one place
    ``launch/serve``, ``serving.scheduler`` and the tests turn weights into a
    served plan.  With a ``mesh`` (and optional ``rules``) every entry
    records its distributed layout, keeps this rank's block of the payload
    and selects from the ``sharded:*`` family."""
    from repro_torch import engine
    rules = rules or (rules_for_mesh(mesh) if mesh is not None else None)
    return engine.build_plan(params, schedule=schedule, cfg=cfg, policy=policy,
                             backend=backend, mesh=mesh, rules=rules,
                             device=device)


def make_prefill_step(cfg, mesh=None, rules: Optional[Rules] = None,
                      max_len: Optional[int] = None, **kw):
    """(params, batch) -> (last-token logits, caches); ``kw`` (e.g.
    ``backend=``) reaches every linear, ``max_len`` pads the caches to the
    decode loop's length.  With a mesh, the step takes its inputs at
    ``launch.specs.input_shardings`` (``place_inputs``) and returns this
    rank's blocks (the sharded serving layout); given whole dense params it
    runs the paged layout (the paged runtime's serial prefill)."""
    def step(params, batch):
        return tfm.prefill(params, batch, cfg, mesh=mesh, rules=rules,
                           max_len=max_len, **kw)
    return step


def make_decode_step(cfg, mesh=None, rules: Optional[Rules] = None, **kw):
    """(params, token, caches, cache_len) -> (logits, caches); with a mesh,
    as :func:`make_prefill_step` says."""
    def step(params, token, caches, cache_len):
        return tfm.decode_step(params, token, caches, cache_len, cfg, mesh=mesh,
                               rules=rules, **kw)
    return step


def make_paged_decode_step(cfg, spec, mesh=None, rules: Optional[Rules] = None,
                           cache_backend: Optional[str] = None, **kw):
    """Decode lane of the paged runtime: one (n_slots, 1) step over the page
    table.  ``spec`` (a :class:`repro_torch.engine.cache.CacheSpec`) rides
    the closure; ``kw`` reaches every linear."""
    def step(params, token, pools, hot, cache_len, page_table, active):
        return tfm.decode_step_paged(params, token, pools, hot, cache_len,
                                     page_table, active, spec, cfg, mesh=mesh,
                                     rules=rules, cache_backend=cache_backend, **kw)
    return step


def make_chunked_prefill_step(cfg, spec, mesh=None, rules: Optional[Rules] = None,
                              cache_backend: Optional[str] = None, **kw):
    """Prefill lane: one fixed-shape (1, chunk) step that every slot's
    prompt advances through, chunk by chunk."""
    def step(params, tokens, pools, hot, page_table, slot, start, valid_len):
        return tfm.prefill_chunk_step(params, tokens, pools, hot, page_table,
                                      slot, start, valid_len, spec, cfg, mesh=mesh,
                                      rules=rules, cache_backend=cache_backend, **kw)
    return step


def make_verify_step(cfg, spec, mesh=None, rules: Optional[Rules] = None,
                     cache_backend: Optional[str] = None, **kw):
    """Verify lane of self-speculative decoding: one fixed-shape (1, k+1)
    step that scores a slot's draft window at full fidelity and writes no
    cache state (the scheduler commits the accepted KV rows itself)."""
    def step(params, tokens, pools, hot, page_table, slot, start):
        return tfm.verify_chunk_step(params, tokens, pools, hot, page_table,
                                     slot, start, spec, cfg, mesh=mesh, rules=rules,
                                     cache_backend=cache_backend, **kw)
    return step
