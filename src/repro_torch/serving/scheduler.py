"""Continuous-batching scheduler over paged, StruM-compressible KV caches
(twin of ``repro.serving.scheduler``).

A priority request queue, slot-based batching, a page allocator and
fixed-shape lanes:

  * **decode lane**: one (n_slots, 1) step; every decoding slot advances
    one token per tick, parked and mid-prefill slots ride the batch masked
    (an ``active`` mask protects their tails and SSM conv / state);
  * **prefill lane**: one (1, prefill_chunk) step that every prompt of
    every slot runs through, chunk by chunk, with ``slot`` / ``start`` /
    ``valid_len`` as device scalars.  ``prefill="serial"`` keeps the
    one-shot prefill (and charges the decode lane the head-of-line stall it
    implies) as the comparison baseline;
  * **speculative lanes** (``speculative=k``): the decode lane becomes a
    draft/verify round -- up to ``k`` draft tokens per slot through the
    decode step on the plan's payload read at reduced fidelity
    (``engine.build_draft_plan``: K9 or K10 on the card), then one (1, k+1)
    verify step per slot at full fidelity whose greedy predictions judge
    the drafts (longest accepted prefix) and give the bonus token.  Greedy
    output equals plain decode's token for token.

SSM (Mamba-2) layer positions have no pages: their conv window and state
are hot per slot, zeroed at admission (the reference leaves a recycled
slot's state to the next request's chunked prefill), carried through the
chunks of the prefill lane and written whole by the serial prefill.

Pages are allocated at admission, sealed when they fill (packed through the
engine's ``cache:*`` codec when ``kv_cache`` is a :class:`StruMConfig`) and
freed at retirement.  With a packed codec on the card, the sealed half of
attention runs in the fused kernels K4 / K5 (``cache:attn_fused*``), which
read the pools' packed bytes by page id.

Weights come as ``params`` (dense, or a served tree), ``plan=`` (a
prebuilt :class:`repro_torch.engine.ExecutionPlan`) or ``schedule=`` (a
:class:`repro_torch.autotune.StruMSchedule` or the path of its JSON, either
package's, + ``backend=``): the deployment end of the profile -> search ->
schedule -> plan -> serve flow.  The scheduler and its tensors live on
``device`` (default ``"cuda"``; raises without a card unless
``device="cpu"``).  Per tick it reads one argmax back to the host
(the speculative lanes one per draft step and one per verify); the lanes
themselves read nothing back.

The tails are written in place, so unlike the reference (which keeps the
pre-draft tails as an immutable value) the speculative round snapshots the
active slots' tails before the draft steps and copies them back before
verify; accepted rows are then copied in.  The tails after every round
equal the reference's.

With a telemetry recorder active the scheduler records the reference's
spans (``sched:*``, ``spec:*``), counters and gauges (``sched/*``,
``spec/drafted``, ``spec/accepted``, ``spec/rounds``) and request
lifecycle events.

``mesh=`` / ``rules=`` (a ``DeviceMesh``, as the reference's scheduler
takes a mesh) thread into the plan the scheduler builds and into every
lane, which run the paged layout (:mod:`repro_torch.models.transformer`):
dense weights whole, packed linears through the ``sharded:*``
compressed-gather family, MoE layers through the expert-parallel body, and
each lane's batch over the data axes where they divide it: the decode lane
computes this rank's slots, the batch-1 prefill lanes their one row on
every rank.  Every rank runs the same scheduler on the same requests.  The
pools and tails stay whole and equal on every rank (the decode lane
all-gathers what it wrote for its slots), and the per-tick token read is
each rank's argmax of its slots, all-gathered over the data axes as
``(n_slots,)`` tokens, so each rank's output is the whole batch's.  No
sharded draft variant exists, so ``speculative`` with a mesh is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device, telemetry
from repro_torch.models import sharding as shd
from repro_torch.launch.steps import (make_chunked_prefill_step,
                                      make_paged_decode_step, make_prefill_step,
                                      make_verify_step)
from repro_torch.serving import pages as pages_mod
from repro_torch.serving.pages import PageAllocator, PagesExhausted

__all__ = ["Request", "BatchScheduler", "PagesExhausted"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any                    # (prompt_len,) int tensor or array
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    priority: int = 0              # higher admits first (FIFO within a tier)
    # teacher forcing: feed these tokens back instead of the argmax; the
    # scheduler still records its own predictions in ``output``
    force_tokens: Optional[list] = None
    # filled by the scheduler:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False

    def _feed(self, k: int, predicted: int) -> int:
        if self.force_tokens is not None and k < len(self.force_tokens):
            return int(self.force_tokens[k])
        return predicted


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: list                    # reserved page ids (sealed in order)
    len: int = 0                   # committed cache positions
    n_sealed: int = 0
    state: str = "prefill"         # "prefill" -> "decode"
    pf_start: int = 0              # next chunk's absolute start position


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


class BatchScheduler:
    """n_slots-way continuous batching over paged caches.

    Cache knobs: ``kv_cache`` (None / "fp" for raw pages, or a
    :class:`StruMConfig` to store sealed pages packed), ``page_size`` (a
    multiple of the codec's ``w``), ``n_pages`` (default: every slot's full
    window), ``cache_backend`` (pins the ``cache:*`` selection: ``"cuda"``,
    ``"torch"``; default by device).  Prefill knobs: ``prefill="chunked"``
    (one ``prefill_chunk``-token chunk per tick, interleaved with the
    decode lane) or ``"serial"``.

    Weight knobs: ``plan=`` or ``schedule=`` (+ ``backend=``, which pins
    the selection family of the plan the scheduler builds), ``mesh=`` /
    ``rules=`` (the module docstring).

    Speculative knobs: ``speculative=k`` (k > 0, needs ``plan=`` or
    ``schedule=``) drafts
    up to ``k`` tokens per slot per tick from the plan's payload at reduced
    fidelity and verifies them at full fidelity; ``draft=`` is a mode
    (``"histream"``, the default, or ``"maskfree_p"``) or an
    :class:`repro_torch.engine.DraftPolicy`.  Attention-only stacks.

    ``lane_runs`` counts the lane steps run: ``decode`` ticks,
    ``prefill_chunk`` chunks, ``prefill_serial`` one-shot prefills, and the
    speculative lane's ``draft`` steps and ``verify`` windows.
    """

    def __init__(self, cfg, params, n_slots: int = 4, max_len: int = 256,
                 mesh=None, rules=None, schedule=None, plan=None, backend=None,
                 kv_cache=None,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefill: str = "chunked", prefill_chunk: Optional[int] = None,
                 cache_backend=None, speculative: int = 0, draft=None,
                 device="cuda"):
        if plan is not None and schedule is not None:
            raise ValueError("pass plan= or schedule=, not both")
        if plan is not None and backend is not None:
            raise ValueError("backend= only applies when the scheduler "
                             "builds the plan (schedule=...); a prebuilt "
                             "plan already recorded its variant selection")
        if prefill not in ("chunked", "serial"):
            raise ValueError(f"prefill={prefill!r}; want 'chunked'|'serial'")
        if speculative and mesh is not None:
            raise ValueError("speculative=k with mesh=: the draft lane has no "
                             "sharded:* variant")
        dev = resolve_device(device)
        if schedule is not None:
            from repro_torch.autotune.schedule import StruMSchedule
            from repro_torch.launch.steps import build_serving_plan
            if isinstance(schedule, (str, bytes)) or hasattr(schedule, "__fspath__"):
                schedule = StruMSchedule.load(schedule)
            plan = build_serving_plan(params, schedule=schedule,
                                      backend=backend, mesh=mesh, rules=rules,
                                      device=dev)
        if plan is not None:
            params = plan.params
            schedule = schedule if schedule is not None else plan.schedule
        self.plan = plan
        self.schedule = schedule
        self.cfg = cfg
        self.device = dev
        self._mesh = mesh
        self.params = _to_device(params, dev)
        self.n_slots = n_slots
        self.max_len = max_len

        # ---- paged cache geometry -------------------------------------
        self.spec = pages_mod.make_cache_spec(cfg, kv_cache, page_size, dev,
                                              backend=cache_backend)
        ps = self.spec.page_size
        self.page_size = ps
        self.pages_per_seq = pages_mod.pages_per_seq(max_len, ps)
        self.prefill_mode = prefill
        self.prefill_chunk = prefill_chunk or ps
        if self.prefill_chunk % ps:
            raise ValueError(f"prefill_chunk={self.prefill_chunk} must be a "
                             f"multiple of page_size={ps}")
        if (self.pages_per_seq * ps) % self.prefill_chunk:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk} must divide the padded "
                f"window {self.pages_per_seq * ps} "
                f"(= pages_per_seq * page_size)")
        self.n_pages = n_pages or n_slots * self.pages_per_seq
        self.allocator = PageAllocator(self.n_pages)
        self.pools = pages_mod.init_pools(cfg, self.n_pages, self.spec)
        self.hot = pages_mod.init_hot(cfg, n_slots, ps, dev)
        self._seal = pages_mod.make_sealer(self.spec)
        # attention positions only: an SSM position's pool is empty
        self._attn_pos = [pos for pos, pool in self.pools.items() if pool]
        self._ssm_pos = [pos for pos in self.hot if pos not in self._attn_pos]

        # ---- lanes -----------------------------------------------------
        self._decode = make_paged_decode_step(cfg, self.spec, mesh, rules,
                                              cache_backend=cache_backend)
        self._chunk_prefill = make_chunked_prefill_step(
            cfg, self.spec, mesh, rules, cache_backend=cache_backend)
        self._prefill = make_prefill_step(cfg, mesh, rules)
        self.lane_runs = {"decode": 0, "prefill_chunk": 0, "prefill_serial": 0,
                          "draft": 0, "verify": 0}

        # ---- speculative lanes ----------------------------------------
        self.speculative = int(speculative)
        self.draft_plan = self.draft_policy = None
        self._draft_decode = self._verify = None
        if self.speculative:
            from repro_torch import engine
            if plan is None:
                raise ValueError(
                    "speculative=k needs a weight plan (plan= or schedule=): the "
                    "draft model is the plan's packed payload read at reduced "
                    "fidelity")
            if any(cfg.layer_kind(i) != "attn" for i in range(cfg.n_layers)):
                raise ValueError(
                    "speculative decoding needs an attention-only stack: SSM "
                    "recurrent state cannot roll back a rejected window")
            pol = (draft if isinstance(draft, engine.DraftPolicy)
                   else engine.DraftPolicy(mode=draft or "histream"))
            self.draft_policy = pol
            # drafted from the served tree, so every payload tensor is the
            # one the verify lane reads
            self.draft_plan = engine.build_draft_plan(
                dataclasses.replace(plan, params=self.params), pol)
            self._draft_params = self.draft_plan.params
            self._draft_decode = self._decode     # the draft plan's params
            self._verify = make_verify_step(cfg, self.spec,
                                            cache_backend=cache_backend)

        # ---- queue / slots --------------------------------------------
        self.queue: list[Request] = []
        self._seq = 0
        self._order: dict[int, int] = {}   # id(req) -> arrival index
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        self._tokens = np.zeros((n_slots,), np.int64)
        self._table = np.full((n_slots, self.pages_per_seq), -1, np.int32)
        self._finished: list[Request] = []
        self._steps = 0
        self._stall = 0                    # serial-mode head-of-line ticks

    def _dev(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    # ------------------------------------------------------------- intake --
    def submit(self, req: Request) -> None:
        """Validate + enqueue; impossible requests fail here, not mid-run."""
        plen = int(req.prompt.shape[0])
        if req.max_new_tokens > 0 and plen > self.max_len - 3:
            telemetry.inc("sched/reject/prompt_too_long")
            raise ValueError(
                f"request {req.uid}: prompt length {plen} does not fit the "
                f"serving window (max_len={self.max_len} leaves room for "
                f"{self.max_len - 3} prompt + 1 decode positions)")
        if self._pages_needed(req) > self.allocator.n_pages:
            telemetry.inc("sched/reject/pages_never_fit")
            raise PagesExhausted(
                f"request {req.uid}: needs {self._pages_needed(req)} pages "
                f"but the pool only holds {self.allocator.n_pages} -- no "
                f"amount of retirement can admit it (raise n_pages=)")
        self._order[id(req)] = self._seq
        self._seq += 1
        self.queue.append(req)
        if telemetry.enabled():
            telemetry.inc("sched/submitted")
            telemetry.request_event(req.uid, "submitted", prompt_len=plen,
                                    max_new_tokens=req.max_new_tokens,
                                    priority=req.priority)
            telemetry.gauge("sched/queue_depth", len(self.queue))

    def _pages_needed(self, req: Request) -> int:
        plen = int(req.prompt.shape[0])
        return min(self.pages_per_seq,
                   -(-(plen + req.max_new_tokens) // self.page_size))

    def _admit(self) -> None:
        while self.queue:
            free = [s for s in range(self.n_slots) if self.slots[s] is None]
            if not free:
                telemetry.inc("sched/admit_wait/no_slot")
                return
            nxt = max(self.queue, key=lambda r: (r.priority, -self._order[id(r)]))
            if nxt.max_new_tokens <= 0:
                # nothing to generate: complete at admission
                self.queue.remove(nxt)
                self._order.pop(id(nxt), None)
                nxt.done = True
                self._finished.append(nxt)
                if telemetry.enabled():
                    telemetry.inc("sched/retired")
                    telemetry.request_event(nxt.uid, "retired", n_tokens=0)
                    telemetry.gauge("sched/queue_depth", len(self.queue))
                continue
            if self.allocator.available < self._pages_needed(nxt):
                telemetry.inc("sched/admit_wait/no_pages")
                return                      # wait for retirements
            self.queue.remove(nxt)
            self._order.pop(id(nxt), None)
            slot = free[0]
            self.slots[slot] = _Slot(req=nxt, pages=self.allocator.alloc(
                self._pages_needed(nxt)))
            self._table[slot] = -1
            self._reset_ssm(slot)
            if telemetry.enabled():
                telemetry.inc("sched/admitted")
                telemetry.request_event(nxt.uid, "admitted", slot=slot,
                                        pages=len(self.slots[slot].pages))
                telemetry.gauge("sched/queue_depth", len(self.queue))
            if self.prefill_mode == "serial":
                self._serial_prefill(slot)

    def _reset_ssm(self, slot: int) -> None:
        """Zero a newly admitted slot's SSM conv window and state: the
        chunked lane continues from them, and a recycled slot still holds
        its last request's."""
        for pos in self._ssm_pos:
            for t in self.hot[pos].values():
                t[:, slot].zero_()

    # ------------------------------------------------------------ sealing --
    def _seal_into(self, slot: int, page_idx: int, kv_pages: dict) -> None:
        """Write one full page per attention position into the pools;
        ``kv_pages[pos]`` is ``(k_page, v_page)``, (g, page_size, KV, hd)."""
        sl = self.slots[slot]
        pid = sl.pages[page_idx]
        with telemetry.span("sched:seal", slot=slot, page=pid):
            for pos in self._attn_pos:
                k_page, v_page = kv_pages[pos]
                self._seal(self.pools[pos], k_page, v_page, pid)
        telemetry.inc("sched/pages_sealed")
        self._table[slot, page_idx] = pid
        sl.n_sealed = page_idx + 1

    def _seal_tails(self, slot: int) -> None:
        """Seal the (now full) tail page of ``slot``."""
        sl = self.slots[slot]
        page_idx = sl.len // self.page_size - 1
        kv_pages = {pos: (self.hot[pos]["k_tail"][:, slot],
                          self.hot[pos]["v_tail"][:, slot])
                    for pos in self._attn_pos}
        self._seal_into(slot, page_idx, kv_pages)

    # ------------------------------------------------------------ prefill --
    def _finish_prefill(self, slot: int, tok: int) -> None:
        """Record the prefill-produced first token; EOS / budget may retire
        the request before it ever decodes."""
        sl = self.slots[slot]
        req = sl.req
        req.output.append(int(tok))
        sl.state = "decode"
        telemetry.request_event(req.uid, "first_token", slot=slot)
        if ((req.eos_id is not None and int(tok) == req.eos_id)
                or len(req.output) >= req.max_new_tokens):
            self._retire(slot)
            return
        telemetry.request_event(req.uid, "decode", slot=slot)
        self._tokens[slot] = req._feed(0, int(tok))

    def _serial_prefill(self, slot: int) -> None:
        """One-shot prefill of the whole prompt + head-of-line stall on the
        decode lane."""
        sl = self.slots[slot]
        prompt = self._dev(sl.req.prompt, torch.long)
        plen = int(prompt.shape[0])
        ps = self.page_size
        telemetry.request_event(sl.req.uid, "prefill", mode="serial",
                                prompt_len=plen)
        with telemetry.span("sched:prefill_serial", slot=slot, prompt_len=plen):
            lg, caches = self._prefill(self.params, {"tokens": prompt[None, :]})
        self.lane_runs["prefill_serial"] += 1
        n_full = plen // ps
        for j in range(n_full):
            kv_pages = {pos: (caches[pos]["k"][:, 0, j * ps:(j + 1) * ps],
                              caches[pos]["v"][:, 0, j * ps:(j + 1) * ps])
                        for pos in self._attn_pos}
            self._seal_into(slot, j, kv_pages)
        r = plen - n_full * ps
        if r:
            for pos in self._attn_pos:
                for name in ("k", "v"):
                    tail = self.hot[pos][f"{name}_tail"]
                    tail[:, slot, :r] = caches[pos][name][:, 0, n_full * ps:plen].to(
                        tail.dtype)
        for pos in self._ssm_pos:
            for name, t in self.hot[pos].items():
                t[:, slot] = caches[pos][name][:, 0].to(t.dtype)
        sl.len = plen
        # the one-shot step owns the device for the whole prompt: charge the
        # decode lane one stall tick per chunk-equivalent
        self._stall += -(-plen // self.prefill_chunk)
        tok = int(lg[0, -1, :self.cfg.vocab_size].argmax())
        self._finish_prefill(slot, tok)

    def _prefill_slots(self) -> list:
        return [s for s in range(self.n_slots)
                if self.slots[s] is not None and self.slots[s].state == "prefill"]

    def _advance_prefill(self, slot: int) -> None:
        """Run one fixed-shape chunk of ``slot``'s prompt."""
        sl = self.slots[slot]
        prompt = sl.req.prompt
        plen = int(prompt.shape[0])
        c = self.prefill_chunk
        start = sl.pf_start
        valid = min(c, plen - start)
        if start == 0:
            telemetry.request_event(sl.req.uid, "prefill", mode="chunked",
                                    prompt_len=plen)
        toks = torch.zeros((1, c), dtype=torch.long, device=self.device)
        toks[0, :valid] = self._dev(prompt[start:start + valid], torch.long)
        with telemetry.span("sched:prefill_chunk", slot=slot, start=start,
                            valid=valid):
            lg, self.hot, chunk_kv = self._chunk_prefill(
                self.params, toks, self.pools, self.hot, self._dev(self._table),
                self._dev(slot), self._dev(start), self._dev(valid))
        self.lane_runs["prefill_chunk"] += 1
        new_len = start + valid
        ps = self.page_size
        for j in range(sl.n_sealed, new_len // ps):
            rel = j * ps - start
            kv_pages = {pos: (chunk_kv[pos]["k"][:, 0, rel:rel + ps],
                              chunk_kv[pos]["v"][:, 0, rel:rel + ps])
                        for pos in self._attn_pos}
            self._seal_into(slot, j, kv_pages)
        sl.pf_start = start + valid
        sl.len = new_len
        if sl.pf_start >= plen:
            tok = int(lg[0, valid - 1, :self.cfg.vocab_size].argmax())
            self._finish_prefill(slot, tok)

    # ------------------------------------------------------------- decode --
    def _retire(self, slot: int) -> None:
        sl = self.slots[slot]
        sl.req.done = True
        self._finished.append(sl.req)
        if telemetry.enabled():
            telemetry.inc("sched/retired")
            telemetry.request_event(sl.req.uid, "retired", slot=slot,
                                    n_tokens=len(sl.req.output))
        self.allocator.free(sl.pages)      # defrags the free list
        self._table[slot] = -1
        self.slots[slot] = None

    def _decode_slots(self) -> list:
        return [s for s in range(self.n_slots)
                if self.slots[s] is not None and self.slots[s].state == "decode"]

    def _cache_len(self) -> np.ndarray:
        cache_len = np.zeros((self.n_slots,), np.int32)
        for s in range(self.n_slots):
            if self.slots[s] is not None:
                cache_len[s] = self.slots[s].len
        return cache_len

    def _argmax(self, lg: torch.Tensor) -> np.ndarray:
        """Greedy tokens of ``lg``'s last axis, read back to the host.  A
        lane's logits of this rank's rows (placed, their batch split over
        the data axes) give this rank's tokens, all-gathered over them."""
        tok = lg[..., :self.cfg.vocab_size].argmax(dim=-1)
        pl = shd.placement(lg)
        if pl is not None and shd.axis_size(self._mesh, pl.spec[0]) > 1:
            tok = shd.all_gather(tok, self._mesh, pl.spec[0], 0)
        return tok.cpu().numpy()

    def _run_decode(self, active: list) -> None:
        mask = np.zeros((self.n_slots,), bool)
        mask[active] = True
        with telemetry.span("sched:decode", n_active=len(active)):
            lg, self.hot = self._decode(
                self.params, self._dev(self._tokens)[:, None], self.pools,
                self.hot, self._dev(self._cache_len()), self._dev(self._table),
                self._dev(mask))
            # the tick's one read back to the host
            nxt = self._argmax(lg)[:, -1]
        self.lane_runs["decode"] += 1
        for s in active:
            sl = self.slots[s]
            req = sl.req
            tok = int(nxt[s])
            req.output.append(tok)
            telemetry.request_event(req.uid, "token", slot=s)
            sl.len += 1
            if sl.len % self.page_size == 0 \
                    and sl.len // self.page_size <= len(sl.pages):
                self._seal_tails(s)
            if ((req.eos_id is not None and tok == req.eos_id)
                    or len(req.output) >= req.max_new_tokens
                    or sl.len >= self.max_len - 2):
                self._retire(s)
                continue
            self._tokens[s] = req._feed(len(req.output) - 1, tok)

    # -------------------------------------------------------- speculative --
    def _commit(self, chunk_kv: dict, slot: int, r: int, n_acc: int) -> None:
        """Copy the first ``n_acc`` verify KV rows of ``slot``'s window into
        its tails at row ``r``, in place: rejected draft KV is never
        written (the rollback)."""
        for pos in self._attn_pos:
            for name in ("k", "v"):
                tail = self.hot[pos][f"{name}_tail"][:, slot]   # (g, ps, KV, hd)
                tail[:, r:r + n_acc] = chunk_kv[pos][name][:, 0, :n_acc]

    def _run_speculative(self, active: list) -> None:
        """One draft/verify round over the decoding slots.

        Per slot: up to ``k_eff`` draft tokens (the draft plan, batched
        through the decode step), then a fixed-shape ``(1, k+1)`` verify
        step at full fidelity whose greedy predictions judge the drafts
        (longest accepted prefix) and give the bonus token, so every token
        out equals plain greedy decode's.  ``k_eff`` caps at the tail's
        remaining room (``page_size - 1 - len % page_size``, so one round
        commits into one page), the request's token budget and the window.
        """
        ps = self.page_size
        C = self.speculative + 1
        base = {s: self.slots[s].len for s in active}
        k_eff = {}
        for s in active:
            sl = self.slots[s]
            k_eff[s] = max(0, min(
                self.speculative,
                ps - 1 - sl.len % ps,
                sl.req.max_new_tokens - len(sl.req.output) - 1,
                (self.max_len - 2) - sl.len - 1))
        max_k = max(k_eff.values(), default=0)
        drafts: dict = {s: [] for s in active}
        if max_k:
            # the draft steps write provisional rows into the tails in place:
            # keep the drafting slots' tails and put them back before verify
            idx = self._dev([s for s in active if k_eff[s]], torch.long)
            saved = {pos: {n: t.index_select(1, idx) for n, t in hp.items()}
                     for pos, hp in self.hot.items()}
            cache_len = self._cache_len()
            cur = np.array(self._tokens, np.int64)
            with telemetry.span("spec:draft", n_active=len(active), k=max_k):
                for j in range(max_k):
                    mask = np.zeros((self.n_slots,), bool)
                    cl = cache_len.copy()
                    for s in active:
                        mask[s] = j < k_eff[s]
                        cl[s] = base[s] + j
                    lg, self.hot = self._draft_decode(
                        self._draft_params, self._dev(cur)[:, None], self.pools,
                        self.hot, self._dev(cl), self._dev(self._table),
                        self._dev(mask))
                    self.lane_runs["draft"] += 1
                    nxt = self._argmax(lg[:, -1])
                    for s in active:
                        if j < k_eff[s]:
                            drafts[s].append(int(nxt[s]))
                            cur[s] = int(nxt[s])
            for pos, hp in self.hot.items():
                for n, t in hp.items():
                    t.index_copy_(1, idx, saved[pos][n])
            telemetry.inc("spec/drafted", sum(k_eff.values()))
        for s in active:
            sl = self.slots[s]
            req = sl.req
            start = base[s]
            toks = np.zeros((1, C), np.int64)
            toks[0, 0] = self._tokens[s]
            toks[0, 1:1 + len(drafts[s])] = drafts[s]
            with telemetry.span("spec:verify", slot=s, k=k_eff[s]):
                lg, chunk_kv = self._verify(
                    self.params, self._dev(toks), self.pools, self.hot,
                    self._dev(self._table), self._dev(s), self._dev(start))
                g = self._argmax(lg[0])
            self.lane_runs["verify"] += 1
            n_acc = 0
            retired = False
            for j in range(k_eff[s] + 1):
                tok = int(g[j])
                req.output.append(tok)
                telemetry.request_event(req.uid, "token", slot=s)
                n_acc = j + 1
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.output) >= req.max_new_tokens
                        or start + n_acc >= self.max_len - 2):
                    retired = True
                    break
                fed = req._feed(len(req.output) - 1, tok)
                # a draft survives iff it is what plain decode would FEED
                # next (the greedy token, unless teacher-forced)
                if j < k_eff[s] and drafts[s][j] == fed:
                    continue
                self._tokens[s] = fed
                break
            self._commit(chunk_kv, s, start % ps, n_acc)
            sl.len = start + n_acc
            telemetry.inc("spec/rounds")
            telemetry.inc("spec/accepted", n_acc - 1)
            if sl.len % ps == 0 and sl.len // ps <= len(sl.pages):
                self._seal_tails(s)
            if retired:
                self._retire(s)

    # -------------------------------------------------------------- drive --
    def step(self) -> int:
        """One scheduler tick: admit, advance one prefill chunk, decode all
        decoding slots (one draft/verify round under ``speculative``).
        Returns the number of requests that progressed."""
        with telemetry.span("sched:step", tick=self._steps):
            self._admit()
            progressed = 0
            prefill_busy = 0
            if self.prefill_mode == "chunked":
                pf = self._prefill_slots()
                if pf:
                    # round-robin by progress: least-advanced first
                    slot = min(pf, key=lambda s: (self.slots[s].pf_start, s))
                    self._advance_prefill(slot)
                    progressed += 1
                    prefill_busy = 1
            if telemetry.enabled():
                telemetry.inc("sched/ticks")
                telemetry.gauge("sched/queue_depth", len(self.queue))
                telemetry.gauge("sched/lane/prefill_busy", prefill_busy)
            if self._stall > 0:
                # serial mode: the one-shot prefill still occupies the device
                self._stall -= 1
                self._steps += 1
                telemetry.inc("sched/stall_ticks")
                telemetry.gauge("sched/lane/decode_active", 0)
                return progressed + len(self._decode_slots())
            active = self._decode_slots()
            telemetry.gauge("sched/lane/decode_active", len(active))
            if active:
                if self.speculative:
                    self._run_speculative(active)
                else:
                    self._run_decode(active)
                progressed += len(active)
            self._steps += 1
            return progressed

    def run_to_completion(self, max_steps: int = 10_000) -> list:
        while (self.queue or any(s is not None for s in self.slots)) and max_steps:
            self.step()
            max_steps -= 1
        out, self._finished = self._finished, []
        return out

    # -------------------------------------------------------------- stats --
    def cache_stats(self) -> dict:
        """Resident cache bytes vs the codec's Eq.-1/2 expectation (see
        :func:`repro_torch.serving.pages.cache_stats`), plus allocator state."""
        out = pages_mod.cache_stats(self.pools, self.hot, self.spec, self.cfg,
                                    self.n_slots, self.max_len)
        out["allocator"] = self.allocator.defrag()
        out["attn_variant"] = self.spec.attn_variant
        out["steps"] = self._steps
        if self.speculative:
            from repro_torch.engine import draft_plan_bytes
            out["speculative"] = dict(k=self.speculative, mode=self.draft_policy.mode,
                                      **draft_plan_bytes(self.draft_plan))
        return out
