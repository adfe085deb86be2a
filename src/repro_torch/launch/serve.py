"""Serving entry point (twin of ``repro.launch.serve``): batched prefill +
greedy decode from StruM-packed weights, or the paged continuous-batching
runtime with StruM-packed KV pages.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \
        --paged --kv-cache mip2q --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch moonshot_v1_16b_a3b --layers 4 [--paged --kv-cache mip2q]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \
        --paged --kv-cache mip2q --speculative 3 --draft histream \
        --trace /tmp/t.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b \
        --schedule sched.json [--paged --kv-cache mip2q]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_780m \
        [--paged]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba_1_5_large_398b --smoke --device cpu --paged
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch olmo_1b --smoke --device cpu --mesh 2x2 [--paged]

builds the model from a seed on the card (``--arch`` takes every config of
the reference: dense, MoE, Mamba-2 and the Jamba hybrid; ``--layers N``
must be a multiple of the architecture's period), packs every linear (and,
for the MoE architectures, every expert stack) into an
:class:`~repro_torch.engine.ExecutionPlan` (``--strum none`` serves dense
weights; ``--schedule PATH`` loads a ``StruMSchedule`` JSON, written by
either package, and packs each tensor with its own config, overriding
``--strum``), prints the weight bytes against dense, the plan's variant
distribution (with a schedule also its packed bytes against the int8 bytes
of the tensors it assigns), the prefill and decode times and a token
sample.  ``--paged``
serves the batch as ``--batch`` requests through
:class:`repro_torch.serving.BatchScheduler` (``--prefill chunked|serial``,
``--page-size``), with sealed KV pages packed by ``--kv-cache`` (the fixed
codec ``StruMConfig(method, p=0.5, q=4, L=7)``; ``none`` keeps raw pages),
and prints the drain time, the ticks, the median decode-only tick, the
cache's bytes against int8 pages and, for SSM layers, the bytes of their
hot conv windows and states.  ``--speculative K`` (with ``--paged``)
drafts up to K tokens per slot per tick from the plan's payload read at
reduced fidelity (``--draft histream``: mask + hi, K9; ``maskfree_p``: hi
only, K10) and verifies them at full fidelity; it prints the acceptance
(accepted over drafted, from the telemetry counters of a recorder scoped to
the run) and the draft's payload bytes over the full payload's.
``--trace PATH`` records telemetry for the whole run and writes a
Chrome-trace JSON to PATH at exit (check it with ``python -m
repro_torch.telemetry.check PATH``).  ``--device cpu`` runs the plain
PyTorch path (the ``torch`` family) without a card; without it and without
a card it raises.  ``--mesh DATAxMODEL`` serves on a ``DeviceMesh`` of that
shape (NCCL on the card, gloo with ``--device cpu``): under ``torchrun``
with DATA x MODEL ranks, or on a world of 1 as ``1x1``; the plan is
mesh-aware (every rank keeps its block of the payload, ``sharded:*``
variants gather the packed bytes) and every rank prints the same report.
The dense-cache loop of every family then runs the sharded serving layout
(``models.sharding``): dense weights placed by ``shard_params``, the
prompt split over the data axes, the attention caches (padded to
``launch.specs.padded_cache_len`` where ``model`` has more than one rank)
also over ``model`` by sequence, the SSM caches by channel and head; only
the sampled tokens (and the logits kept for the report) are gathered
whole.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import torch

from repro_torch import resolve_device, telemetry
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.policy import StruMConfig
from repro_torch.launch.steps import (build_serving_plan, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import model_defs
from repro_torch.models.params import init_params
from repro_torch.models.quantize import serve_tree_bytes

__all__ = ["pad_caches", "decode_cache_len", "serving_setup", "serve", "serve_paged",
           "greedy_tokens", "ssm_hot_bytes", "run", "main"]


def pad_caches(caches: dict, extra: int) -> dict:
    """Grow attention caches by ``extra`` decode slots along the sequence
    axis, axis 2 of ``(groups, B, S, KV, hd)``."""
    def pad(x):
        shape = list(x.shape)
        shape[2] = extra
        return torch.cat([x, x.new_zeros(shape)], dim=2)
    return {pos: {n: pad(t) if n in ("k", "v") else t for n, t in c.items()}
            for pos, c in caches.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_cache_len(mesh, seq_len: int) -> int:
    """The decode loop's cache length for ``seq_len`` positions: one
    headroom slot, rounded up by ``launch.specs.padded_cache_len`` where the
    sharded serving layout splits the cache's sequence over a ``model`` axis
    of more than one rank (the split must divide it)."""
    from repro_torch.launch.specs import padded_cache_len
    from repro_torch.models import sharding as shd
    if mesh is not None and shd.axis_size(mesh, shd.tp_axis(mesh)) > 1:
        return padded_cache_len(seq_len)
    return seq_len + 1


def serving_setup(cfg, params, prompt: torch.Tensor, gen: int, *, mesh=None,
                  rules=None, **kw):
    """The dense-cache loop's set-up, shared by :func:`serve` and
    ``launch.profile``: ``(params, prompt, prefill step, decode step)``.  On
    a ``mesh`` the params and the prompt are this rank's blocks
    (``launch.specs.place_inputs``); the prefill's caches hold
    :func:`decode_cache_len` positions, enough for ``gen`` decode steps."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import place_inputs
    from repro_torch.models import sharding as shd
    b, n = prompt.shape
    if mesh is not None:
        rules = rules or shd.rules_for_mesh(mesh, b)
        params, batch = place_inputs(cfg, ShapeSpec("serve", n, b, "prefill"),
                                     (params, {"tokens": prompt}), mesh, rules)
        prompt = batch["tokens"]
    max_len = decode_cache_len(mesh, n + gen)
    return (params, prompt, make_prefill_step(cfg, mesh, rules, max_len=max_len, **kw),
            make_decode_step(cfg, mesh, rules, **kw))


@torch.inference_mode()
def serve(cfg, params, prompt: torch.Tensor, gen: int, *, device="cuda",
          return_logits: bool = False, warmup: bool = True, mesh=None,
          rules=None, **kw):
    """Prefill ``prompt`` (B, S) then ``gen`` greedy decode steps.

    Returns ``(tokens (B, gen+1), prefill_s, decode_s)``, plus the f32 logits
    of every step ``(B, gen+1, V)`` when ``return_logits``; ``kw`` (e.g.
    ``backend=``) reaches every linear.  With ``warmup`` one untimed prefill
    and decode step run first, so the times leave out the first calls'
    set-up (library handles, allocator growth, kernel loading).  On a
    ``mesh`` every family serves in the sharded serving layout
    (:func:`serving_setup`; ``params`` whole or already placed): each rank
    computes its rows and blocks, the greedy token is a vocab-parallel
    argmax (:func:`greedy_tokens`), and only the tokens and the returned
    logits are gathered whole.  Tokens and logits come back whole on every
    rank.
    """
    dev = resolve_device(device)
    n = prompt.shape[1]
    params, rows, prefill_fn, decode_fn = serving_setup(
        cfg, params, prompt.to(dev), gen, mesh=mesh, rules=rules, **kw)
    if warmup:
        lg, caches = prefill_fn(params, {"tokens": rows})
        decode_fn(params, greedy_tokens(lg, mesh, cfg.vocab_size), caches, n)
    _sync(dev)
    t0 = time.perf_counter()
    lg, caches = prefill_fn(params, {"tokens": rows})
    steps = [lg[:, -1]]
    toks = [greedy_tokens(lg, mesh, cfg.vocab_size)]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(gen):
        lg, caches = decode_fn(params, toks[-1], caches, n + i)
        steps.append(lg[:, -1])
        toks.append(greedy_tokens(lg, mesh, cfg.vocab_size))
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = (_whole_like(torch.cat(toks, dim=1), toks[0], mesh), t_prefill, t_decode)
    if not return_logits:
        return out
    return out + (_whole_like(torch.stack(steps, dim=1), lg, mesh),)


def _whole_like(t: torch.Tensor, like: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, a block placed as ``like`` is, gathered whole; ``t`` itself
    when ``like`` is whole."""
    from repro_torch.models import sharding as shd
    pl = shd.placement(like)
    return t if pl is None else shd.gather_whole(shd.place(t, mesh, pl.spec), mesh)


def greedy_tokens(lg: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """``argmax(lg[:, -1, :vocab])`` as ``(B, 1)``.  Of a placed logits
    block ``(B_l, S, V_l)`` (rows and a vocab block; the sharded serving
    layout): each rank's first maximum over its valid columns, then the
    first maximum over the ranks of the vocab axes, which is the first
    maximum of the whole row; this rank's rows' tokens ``(B_l, 1)``,
    placed."""
    from repro_torch.models import sharding as shd
    pl = shd.placement(lg)
    if pl is None:
        return lg[:, -1, :vocab].argmax(-1)[:, None]
    entry = pl.spec[2]
    v_l = lg.shape[-1]
    v0 = shd.axis_index(mesh, entry) * v_l if shd.axis_size(mesh, entry) > 1 else 0
    cols = v0 + torch.arange(v_l, device=lg.device)
    row = torch.where(cols < vocab, lg[:, -1], torch.full_like(lg[:, -1], -torch.inf))
    best, idx = row.max(dim=-1)
    if shd.axis_size(mesh, entry) > 1:
        bests = shd.all_gather(best[None], mesh, entry, 0)
        idxs = shd.all_gather((idx + v0)[None], mesh, entry, 0)
        pick = bests.argmax(dim=0)
        idx = idxs.gather(0, pick[None])[0]
    return shd.place(idx[:, None], mesh, shd.P(pl.spec[0], None))


def serve_paged(cfg, params, prompt: torch.Tensor, gen: int, *, plan=None,
                kv_cache=None, page_size: int = 16, prefill: str = "chunked",
                speculative: int = 0, draft=None, mesh=None, rules=None,
                device="cuda") -> dict:
    """Serve each row of ``prompt`` (B, S) as one request of ``gen + 1``
    tokens through a :class:`BatchScheduler` with B slots and ``max_len =
    S + gen + page_size``, timing every tick (host clock, synchronized).

    One untimed request first runs through a one-slot scheduler of the same
    configuration (kernel builds, first-call set-up).  Returns the
    scheduler, the finished requests, the drain seconds, each tick's
    ``(kind, ms)`` (kind "decode" when no prompt waited or was prefilling
    before the tick) and ``lane_runs`` summed over both schedulers; with
    ``speculative`` also ``spec``, the ``spec/*`` counters of a recorder
    scoped to the timed run.
    """
    from repro_torch.serving import BatchScheduler, Request
    dev = resolve_device(device)
    b, n = prompt.shape
    prompt = prompt.cpu()

    def make(slots):
        return BatchScheduler(cfg, params, n_slots=slots, max_len=n + gen + page_size,
                              mesh=mesh, rules=rules,
                              plan=plan, kv_cache=kv_cache, page_size=page_size,
                              prefill=prefill, speculative=speculative,
                              draft=draft, device=dev)
    w = make(1)
    w.submit(Request(uid=-1, prompt=prompt[0, :page_size + 1], max_new_tokens=2))
    w.run_to_completion()
    lane_runs = dict(w.lane_runs)
    sched = make(b)
    for i in range(b):
        sched.submit(Request(uid=i, prompt=prompt[i], max_new_tokens=gen + 1))
    ticks = []
    with (telemetry.recording() if speculative else contextlib.nullcontext()) as rec:
        _sync(dev)
        t0 = time.perf_counter()
        while sched.queue or any(s is not None for s in sched.slots):
            decode_only = not sched.queue and not sched._prefill_slots()
            t1 = time.perf_counter()
            sched.step()
            _sync(dev)
            ticks.append(("decode" if decode_only else "mixed",
                          (time.perf_counter() - t1) * 1e3))
        drain = time.perf_counter() - t0
    # nothing is left to run: this only collects the finished requests
    done = sorted(sched.run_to_completion(), key=lambda r: r.uid)
    for k, v in sched.lane_runs.items():
        lane_runs[k] += v
    out = {"sched": sched, "requests": done, "drain_s": drain, "ticks": ticks,
           "lane_runs": lane_runs}
    if speculative:
        out["spec"] = rec.counters("spec/")
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--strum", default="mip2q",
                    choices=["none", "sparsity", "dliq", "mip2q"])
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first N layers (full width)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default=None, metavar="PATH",
                    help="autotuned StruMSchedule JSON (overrides --strum)")
    ap.add_argument("--backend", default=None, choices=["auto", "cuda", "torch"],
                    help="pin the engine's kernel-variant family")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged continuous-batching runtime "
                         "(BatchScheduler) instead of the dense-cache loop")
    ap.add_argument("--kv-cache", default="none",
                    choices=["none", "sparsity", "dliq", "mip2q"],
                    help="(--paged) pack sealed KV pages with this codec")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill", default="chunked", choices=["chunked", "serial"])
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="(--paged) self-speculative decoding: draft up to K "
                         "tokens per slot per tick from the packed payload read "
                         "at reduced fidelity, then verify at full fidelity "
                         "(token-identical greedy output)")
    ap.add_argument("--draft", default="histream", choices=["histream", "maskfree_p"],
                    help="(--speculative) which streams the draft lane reads: "
                         "histream = mask + hi (skip lo), maskfree_p = hi only")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record telemetry and write a Chrome-trace JSON to PATH "
                         "at exit; open it in Perfetto or chrome://tracing")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a device mesh, e.g. 2x2 under torchrun with 4 "
                         "ranks, or 1x1; plans then select sharded:* variants")
    return ap


def run(argv=None) -> dict:
    """Parse ``argv``, build, pack and serve; returns what ``main`` prints
    (config, plan, served params, prompt, tokens, logits, times, bytes)."""
    args = _parser().parse_args(argv)
    if args.speculative and not args.paged:
        raise ValueError("--speculative needs --paged (the speculative lane is "
                         "the paged runtime's)")
    if args.trace:
        telemetry.configure(trace_path=args.trace)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = init_params(model_defs(cfg), seed=args.seed, device=dev,
                         dtype_override="float32")
    res = {"dense_bytes": serve_tree_bytes(params), "plan": None, "mesh": None}
    mesh = rules = None
    if args.mesh is not None:
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.sharding import rules_for_mesh
        data, model = (int(v) for v in args.mesh.lower().split("x"))
        mesh = make_host_mesh(data=data, model=model, device=dev)
        rules = rules_for_mesh(mesh, args.batch)
        res["mesh"] = mesh
    if args.schedule is not None:
        from repro_torch.autotune.schedule import StruMSchedule
        plan = build_serving_plan(params, schedule=StruMSchedule.load(args.schedule),
                                  backend=args.backend, mesh=mesh, rules=rules,
                                  device=dev)
        params = plan.params
        res.update(plan=plan, packed_bytes=plan.serve_bytes(),
                   ratio_note=f"schedule {args.schedule}")
    elif args.strum != "none":
        scfg = StruMConfig(method=args.strum, p=args.p, q=args.q, L=args.L)
        cfg = dataclasses.replace(cfg, strum=scfg)
        plan = build_serving_plan(params, cfg=scfg, backend=args.backend,
                                  mesh=mesh, rules=rules, device=dev)
        params = plan.params
        res.update(plan=plan, packed_bytes=plan.serve_bytes(),
                   ratio_note=f"theoretical vs int8 r={scfg.compression_ratio:.4f}")
    gen = torch.Generator().manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    res.update(cfg=cfg, params=params, prompt=prompt, gen=args.gen, device=dev,
               paged=args.paged)
    if args.paged:
        kv = None if args.kv_cache == "none" else \
            StruMConfig(method=args.kv_cache, p=0.5, q=4, L=7)
        res.update(serve_paged(cfg, params, prompt, args.gen, plan=res["plan"],
                               kv_cache=kv, page_size=args.page_size,
                               prefill=args.prefill, speculative=args.speculative,
                               draft=args.draft, mesh=mesh, rules=rules,
                               device=dev))
        return res
    toks, t_p, t_d, lg = serve(cfg, params, prompt, args.gen, device=dev,
                               return_logits=True, mesh=mesh, rules=rules)
    res.update(tokens=toks, logits=lg, t_prefill=t_p, t_decode=t_d)
    return res


def report(res: dict) -> list:
    """The lines ``main`` prints for a :func:`run` result."""
    dense, cfg = res["dense_bytes"], res["cfg"]
    lines = [f"model: {cfg.name}, {cfg.n_layers} layers, {cfg.param_count():,} params, "
             f"{cfg.active_param_count():,} active per token"]
    if res["mesh"] is not None:
        from repro_torch.models.sharding import axis_sizes
        lines.append(f"mesh: {axis_sizes(res['mesh'])} ({res['mesh'].device_type})")
    if res["plan"] is not None:
        comp, summ = res["packed_bytes"], res["plan"].summary()
        lines.append(f"weights: dense {dense / 1e6:.2f} MB -> StruM "
                     f"{comp / 1e6:.2f} MB (x{comp / dense:.3f}; "
                     f"{res['ratio_note']})")
        lines.append(f"plan: {summ['n_entries']} entries, variants "
                     f"{summ['variant_distribution']} (backend {summ['backend']})")
        if res["plan"].schedule is not None:
            lines.append(_schedule_line(res["plan"]))
    else:
        lines.append(f"weights: dense {dense / 1e6:.2f} MB")
    if res["paged"]:
        return lines + _paged_report(res)
    gen = res["gen"]
    lines.append(f"prefill {res['t_prefill'] * 1e3:.1f} ms; decode "
                 f"{res['t_decode'] * 1e3:.1f} ms ({gen} steps, "
                 f"{res['t_decode'] / max(gen, 1) * 1e3:.2f} ms/tok) on "
                 f"{res['device']}")
    lines.append(f"sample: {res['tokens'][0, :16].tolist()}")
    return lines


def _schedule_line(plan) -> str:
    """A schedule plan's configs and its realized packed bytes against the
    int8 bytes of the tensors it packs."""
    import math
    sched = plan.schedule
    int8 = sum(math.prod(e.shape) for e in plan.entries.values())
    payload = plan.summary()["packed_payload_bytes"]
    dense = sum(cfg is None for cfg in sched.assignments.values())
    return (f"schedule: {len(sched.assignments)} tensors assigned ({dense} kept "
            f"dense), configs {sched.summary()['config_distribution']}; packed "
            f"{payload / 1e6:.3f} MB = x{payload / max(int8, 1):.4f} of their int8 "
            f"{int8 / 1e6:.3f} MB")


def _paged_report(res: dict) -> list:
    sched, st = res["sched"], res["sched"].cache_stats()
    dec = sorted(ms for kind, ms in res["ticks"] if kind == "decode")
    med = f"{dec[len(dec) // 2]:.2f} ms over {len(dec)}" if dec else "none"
    spec = []
    if sched.speculative:
        c, sp = res["spec"], st["speculative"]
        acc = c.get("accepted", 0) / c["drafted"] if c.get("drafted") else float("nan")
        spec = [f"speculative: k={sp['k']} draft={sp['mode']} acceptance {acc:.3f} "
                f"({int(c.get('accepted', 0))} of {int(c.get('drafted', 0))} drafts "
                f"in {int(c.get('rounds', 0))} rounds; payload ratio "
                f"{sp['ratio']:.4f})"]
    return spec + [
        f"paged serve: {len(res['requests'])} requests in "
        f"{res['drain_s'] * 1e3:.1f} ms ({len(res['ticks'])} ticks, "
        f"{sched.prefill_mode} prefill) on {res['device']}; decode-only tick "
        f"median {med}",
        f"cache: codec {st['codec']}, attention {st['attn_variant']}; packed "
        f"pages {st['resident_page_bytes'] / 1e6:.3f} MB, x{st['ratio_vs_int8']:.4f} "
        f"vs int8 pages{_ssm_note(sched)}; lane runs {res['lane_runs']}",
        f"sample: {res['requests'][0].output[:16]}"]


def ssm_hot_bytes(sched) -> int:
    """Bytes of a scheduler's SSM hot state (conv windows and f32 states of
    every slot and layer); 0 for attention-only stacks."""
    return sum(t.numel() * t.element_size() for hp in sched.hot.values()
               if "state" in hp for t in hp.values())


def _ssm_note(sched) -> str:
    if not ssm_hot_bytes(sched):
        return ""
    return (f"; SSM hot state {ssm_hot_bytes(sched) / 1e6:.3f} MB (conv + state, "
            f"{sched.n_slots} slots)")


def _telemetry_report() -> list:
    """End-of-run summary of the active recorder (``--trace`` /
    ``STRUM_TRACE``), as the reference's serve entry point prints it."""
    rec = telemetry.current()
    if rec is None:
        return []
    lines = []
    lat = rec.latency_summary()
    if lat["n_requests"]:
        def ms(v):
            return "n/a" if v is None else f"{v / 1e3:.1f} ms"
        gp = lat["goodput_tok_s"]
        lines.append(f"telemetry: {lat['n_retired']}/{lat['n_requests']} retired; "
                     f"ttft p50/p99 {ms(lat['ttft_p50_us'])}/{ms(lat['ttft_p99_us'])}; "
                     f"tok p50/p99 {ms(lat['tok_p50_us'])}/{ms(lat['tok_p99_us'])}; "
                     f"goodput {'n/a' if gp is None else f'{gp:.1f} tok/s'}")
    disp = rec.counters("dispatch/variant/")
    if disp:
        counts = {k: int(v) for k, v in sorted(disp.items())}
        lines.append(f"telemetry: dispatch {counts}; packed bytes "
                     f"{int(rec.counter('dispatch/packed_bytes'))}")
    cache = rec.counters("cache/")
    if cache:
        lines.append(f"telemetry: cache {dict(sorted(cache.items()))}")
    return lines


def main(argv=None) -> int:
    for line in report(run(argv)) + _telemetry_report():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
