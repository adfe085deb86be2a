"""Multi-rank runs of the port for the CPU tests: gloo ranks spawned with
``torch.multiprocessing``, one intra-op thread each, and the rank bodies of
``tests/test_torch_sharded.py`` and ``tests/test_torch_distributed.py``.

This module imports ``torch`` and ``repro_torch`` only: a spawned rank
re-imports the module of the function it runs, and the test modules import
JAX.  Inputs come from an ``.npz`` the test writes (seeded numpy arrays and
the reference's parameters); every rank returns a dict of numpy arrays and
plain values.
"""
from __future__ import annotations

import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

FIELDS = ("mask", "hi", "lo", "scale")


def _entry(fn, rank: int, world: int, store: str, args: tuple, out) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        res = fn(rank, world, *args)
        dist.barrier()
        out.put((rank, res, None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout: float = 600.0, abort=None) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` gloo ranks; returns the
    ranks' results in rank order, or raises with the first rank's
    traceback.

    The ranks meet through a file store in a fresh temporary directory (no
    TCP port is picked in advance, so nothing else on the machine can take
    it first).  The wait ends as soon as a rank reports an error, exits
    without a result, or ``abort()`` returns a message (the caller's
    reference run failed); else it lasts until ``timeout`` seconds pass
    without a rank's result.  Every rank is joined (or ended) before it
    returns."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks-")
    store = os.path.join(tmp, "store")
    env = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = []
    try:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, store, args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results, errors = {}, []
    t0 = deadline = time.monotonic()
    deadline += timeout
    try:
        while len(results) < world and not errors:
            try:
                rank, res, err = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                why = abort() if abort is not None else None
                if dead:
                    errors.append(f"rank {dead[0]} exited with code "
                                  f"{procs[dead[0]].exitcode} and no result")
                elif why:
                    errors.append(why)
                elif time.monotonic() > deadline:
                    errors.append(f"timed out after {time.monotonic() - t0:.0f} s "
                                  f"with {sorted(results)} done")
                continue
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
            else:
                results[rank] = res
                deadline = time.monotonic() + timeout
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError(errors[0])
    return [results[r] for r in range(world)]


#: Python's hash salt of the subprocess that draws the reference's weights
#: (its ``init_params`` keys each leaf by ``hash(name)``)
HASH_SEED = "1"


def draw_inputs(module: str, path: str, cwd: str) -> None:
    """Run ``module._inputs(path)`` in a subprocess with Python's hash salt
    fixed to :data:`HASH_SEED`, so the weights are the same in every run
    (drawn in the test process, they change with its salt)."""
    env = {**os.environ, "PYTHONHASHSEED": HASH_SEED, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(["src", "tests"])}
    subprocess.run([sys.executable, "-c", f"import sys, {module}; "
                    f"{module}._inputs(sys.argv[1])", path],
                   check=True, env=env, cwd=cwd, timeout=600)


#: the XLA flags of a pinned reference run: one thread, so XLA's CPU
#: reductions sum in one order whatever else runs on the machine
PINNED_XLA_FLAGS = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"


def pinned_reference(module: str, func: str, path: str, cwd: str, *args) -> None:
    """Run ``module.func(path, *args)`` in a subprocess whose process state
    is fixed: XLA on the CPU with :data:`PINNED_XLA_FLAGS`, no
    ``STRUM_INTERPRET`` (the reference's analysis CLI sets it for the rest
    of a process that calls it).  What the reference computes then does not
    depend on what ran before it in the caller's process.  (Python's hash
    salt is not pinned: ``func`` draws no weight that depends on it.)"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("STRUM_INTERPRET", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", XLA_FLAGS=PINNED_XLA_FLAGS,
               PYTHONPATH=os.pathsep.join(["src", "tests"]))
    subprocess.run([sys.executable, "-c", f"import sys, {module}; "
                    f"{module}.{func}(*sys.argv[1:])", path, *args],
                   check=True, env=env, cwd=cwd, timeout=600)


def reference_run(script: str, args: list, env: dict, cwd: str,
                  timeout: float = 600.0) -> subprocess.Popen:
    """Start a reference script (``python -c script *args``) beside the
    ranks, its output in temporary files; :func:`finish` collects it."""
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    p = subprocess.Popen([sys.executable, "-c", script, *args], env=env, cwd=cwd,
                         stdout=logs[0], stderr=logs[1], text=True)
    p.logs, p.t0, p.failure = logs, time.monotonic(), None
    p.deadline = p.t0 + timeout
    return p


def _output(p: subprocess.Popen) -> tuple:
    out = []
    for f in p.logs:
        f.seek(0)
        out.append(f.read())
        f.close()
    return tuple(out)


def reference_failed(p: subprocess.Popen):
    """``spawn``'s ``abort``: a message once the reference run has failed."""
    def check():
        if p.failure is None and p.poll() not in (None, 0):
            out, err = _output(p)
            p.failure = (f"reference run exited with {p.returncode} after "
                         f"{time.monotonic() - p.t0:.0f} s:\n{out}\n{err}")
        return p.failure
    return check


def finish(p: subprocess.Popen) -> str:
    """The reference run's standard output, once it ends with code 0."""
    if p.failure is not None:
        raise AssertionError(p.failure)
    try:
        p.wait(timeout=max(1.0, p.deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        out, err = _output(p)
        raise AssertionError(f"reference run timed out after "
                             f"{time.monotonic() - p.t0:.0f} s:\n{out}\n{err}")
    out, err = _output(p)
    assert p.returncode == 0, out + "\n" + err
    return out


# --------------------------------------------------------------- helpers --

def flatten(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> ``{"a/b/c": array}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The sub-tree of ``flatten``'s output under ``prefix`` as torch
    tensors on the CPU."""
    tree: dict = {}
    for name, v in flat.items():
        if not name.startswith(prefix + "/"):
            continue
        node = tree
        parts = name[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.tensor(np.asarray(v))
    return tree


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _fields(leaf: dict) -> dict:
    return {k: _np(leaf[k]) for k in FIELDS}


def _gathered(y: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    from repro_torch.models import sharding as shd
    return shd.all_gather(y, mesh, axes, dim)


# ------------------------------------------------- test_torch_sharded.py --

def sharded_cases(rank: int, world: int, path: str) -> dict:
    """The 4 x 2 ("data", "model") mesh cases and the FSDP-only mesh case."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import engine, telemetry
    from repro_torch.autotune.schedule import StruMSchedule
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.policy import StruMConfig
    from repro_torch.engine.dispatch import dequant_leaf, dispatch, dispatch_grouped
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import place_inputs
    from repro_torch.launch.steps import build_serving_plan, make_prefill_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding as shd

    data = dict(np.load(path))
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    mesh = make_host_mesh(data=4, model=2, device="cpu")
    res: dict = {"coord": (shd.axis_index(mesh, "data"), shd.axis_index(mesh, "model"))}
    t = lambda k: torch.tensor(data[k])  # noqa: E731

    # -- plan parity: col, row and an expert stack on 4 x 2 ------------------
    params = {"blocks": {"mlp": {"wi": {"w": t("w_wi")}, "wo": {"w": t("w_wo")}},
                         "moe": {"wi": t("w_stack")}}}
    plan = engine.build_plan(params, cfg=scfg, backend="cuda", mesh=mesh,
                             device="cpu")
    res["dist"] = plan.summary()["variant_distribution"]
    res["payload_bytes"] = plan.summary()["packed_payload_bytes"]
    local = engine.build_plan(params, cfg=scfg, device="cpu")
    for nm in ("wi", "wo"):
        leaf = plan.params["blocks"]["mlp"][nm]["w"]
        res[f"{nm}_pattern"] = leaf["spec"].shard.tp_pattern
        res[f"{nm}_fields"] = _fields(leaf)
        x = t(f"x_{nm}")
        res[f"{nm}_y"] = _np(dispatch(leaf, x, mesh=mesh))
        res[f"{nm}_want"] = _np(x @ dequant_leaf(local.params["blocks"]["mlp"][nm]["w"],
                                                 torch.float32))
        # a mesh-less plan's (global) leaf served on the mesh
        res[f"{nm}_y_global_leaf"] = _np(dispatch(
            local.params["blocks"]["mlp"][nm]["w"], x, mesh=mesh,
            tp_pattern=res[f"{nm}_pattern"]))
        try:
            dispatch(leaf, x)
            res[f"{nm}_no_mesh"] = "served"
        except ValueError as e:
            res[f"{nm}_no_mesh"] = str(e)
        for m in (6, 1, 13):      # ragged M: none divides the 4-way FSDP axis
            xm = t(f"x_{nm}_m{m}")
            res[f"{nm}_ragged{m}"] = (
                _np(dispatch(leaf, xm, mesh=mesh)),
                _np(xm @ dequant_leaf(local.params["blocks"]["mlp"][nm]["w"],
                                      torch.float32)))
    stack = plan.params["blocks"]["moe"]["wi"]
    res["stack_variant"] = stack["spec"].variant
    res["stack_lead_axis"] = stack["spec"].shard.lead_axis
    res["stack_fields"] = _fields(stack)
    xb = shd.shard_slice(t("xb"), shd.P("model"), mesh)
    yg = dispatch_grouped(stack, xb, strum=scfg, fsdp_axes=("data",), mesh=mesh)
    res["stack_y"] = _np(_gathered(yg, mesh, "model", 0))
    res["stack_want"] = _np(torch.matmul(
        t("xb"), dequant_leaf(local.params["blocks"]["moe"]["wi"], torch.float32)))

    # -- packed bytes, not dequantized ---------------------------------------
    leaf = plan.params["blocks"]["mlp"]["wi"]["w"]
    with telemetry.recording() as rec:
        dispatch(leaf, t("x_wi"), mesh=mesh)
    res["counters"] = {k: int(v) for k, v in rec.counters().items()}
    res["whole_payload"] = local.entries["blocks/mlp/wi/w"].payload_bytes()

    # -- the post-gather kernel sees the per-call backend ---------------------
    calls = []

    @engine.register_kernel("test:probe", family="torch", priority=99,
                            supports=lambda c, i: not i.lead)
    def probe(x2, packed, *, out_dtype=None):
        calls.append(tuple(x2.shape))
        return torch.zeros((x2.shape[0], packed.n_out), dtype=out_dtype or x2.dtype)
    try:
        gleaf = dict(local.params["blocks"]["mlp"]["wi"]["w"])
        gleaf.pop("spec")
        y = dispatch(gleaf, t("x_wi"), mesh=mesh, tp_pattern="col", backend="cuda")
        res["probe_cuda"] = (list(calls), float(y.abs().max()))
        calls.clear()
        dispatch(gleaf, t("x_wi"), mesh=mesh, tp_pattern="col", backend="torch")
        res["probe_torch"] = list(calls)
    finally:
        engine.unregister_kernel("test:probe")

    # -- the MoE model through sharded:grouped_gather -------------------------
    mcfg = get_smoke_config("qwen3_moe_235b_a22b")
    mscfg = StruMConfig(method="mip2q", p=0.5, L=5, w=16)
    import dataclasses
    mcfg = dataclasses.replace(mcfg, strum=mscfg)
    mp_ = {"blocks": {"moe": unflatten(data, "moe_params")}}
    mplan = engine.build_plan(mp_, cfg=mscfg, mesh=mesh, device="cpu")
    res["moe_dist"] = mplan.summary()["variant_distribution"]
    mlocal = engine.build_plan(mp_, cfg=mscfg, device="cpu")
    x = t("moe_x")
    y_l, a_l = moe_mod.moe_apply(mlocal.params["blocks"]["moe"], x, mcfg)
    y_d, a_d = moe_mod.moe_apply(mplan.params["blocks"]["moe"], x, mcfg, mesh=mesh)
    res["moe"] = (_np(y_l), float(a_l), _np(y_d), float(a_d))

    # the plan's backend reaches the post-gather grouped kernel
    gcalls = []

    @engine.register_kernel("test:gprobe", family="reference", priority=99,
                            grouped=True, supports=lambda c, i: bool(i.lead))
    def gprobe(xg, packed, *, out_dtype=None, rows=None):
        gcalls.append(tuple(xg.shape))
        return torch.zeros(tuple(xg.shape[:-1]) + (packed.n_out,),
                           dtype=out_dtype or xg.dtype)
    try:
        for backend in ("reference", None):
            p_b = engine.build_plan(mp_, cfg=mscfg, backend=backend, mesh=mesh,
                                    device="cpu")
            moe_mod.moe_apply(p_b.params["blocks"]["moe"], torch.zeros_like(x),
                              mcfg, mesh=mesh)
            res[f"gprobe_{backend}"] = len(gcalls)
            gcalls.clear()
    finally:
        engine.unregister_kernel("test:gprobe")

    # -- a schedule-built plan threads the mesh into the forwards ------------
    qcfg = dataclasses.replace(get_smoke_config("qwen2_7b"), strum=None,
                               dtype="float32")
    qp = unflatten(data, "qwen_params")
    sched = StruMSchedule(assignments={
        n: StruMConfig(method="mip2q", p=0.5, L=5) for n in data["sched_names"]})
    rules = shd.rules_for_mesh(mesh)
    splan = build_serving_plan(qp, schedule=sched, mesh=mesh, rules=rules,
                               device="cpu")
    res["sched_dist"] = splan.summary()["variant_distribution"]
    batch = {"tokens": torch.ones((4, 8), dtype=torch.long)}
    # the sharded serving layout: inputs at the reference's specs, logits
    # this rank's block, gathered whole to compare
    shape = ShapeSpec("prefill_4x8", 8, 4, "prefill")
    placed = place_inputs(qcfg, shape, (splan.params, batch), mesh, rules)
    with telemetry.recording() as rec:
        lg, _ = make_prefill_step(qcfg, mesh, rules)(*placed)
    lg = shd.gather_whole(lg, mesh)
    res["sched_gathered"] = int(rec.counter("dispatch/sharded/gathered_packed_bytes"))
    single = build_serving_plan(qp, schedule=sched, device="cpu")
    lg1, _ = make_prefill_step(qcfg)(single.params, batch)
    res["sched_lg"] = (_np(lg), _np(lg1))

    # -- an FSDP-only mesh (no "model" axis) ----------------------------------
    fmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    fparams = {"mlp": {"wi": {"w": t("f_wi")}, "wo": {"w": t("f_wo")}}}
    fplan = engine.build_plan(fparams, cfg=scfg, backend="cuda", mesh=fmesh,
                              device="cpu")
    flocal = engine.build_plan(fparams, cfg=scfg, device="cpu")
    for nm in ("wi", "wo"):
        x = t(f"f_x_{nm}")
        leaf = fplan.params["mlp"][nm]["w"]
        res[f"fsdp_{nm}"] = (leaf["spec"].variant, _np(dispatch(leaf, x, mesh=fmesh)),
                             _np(x @ dequant_leaf(flocal.params["mlp"][nm]["w"],
                                                  torch.float32)))
    return res


# --------------------------------------------- test_torch_distributed.py --

def distributed_cases(rank: int, world: int, path: str, workdir: str) -> dict:
    """The 2 x 2 mesh cases, the pipeline on pp = 4, the ZeRO-3 step and the
    elastic checkpoint round trip (saved on 2 x 2, restored on 4 x 1 and on
    one device), the scheduler and ``serve --mesh``."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import engine
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.apply import fake_quantize_array
    from repro_torch.core.policy import StruMConfig, default_policy
    from repro_torch.engine.sharded import gather_dequant_leaf
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import place_inputs
    from repro_torch.launch.steps import build_serving_plan, make_train_step
    from repro_torch.models import decode_step, model_defs, prefill
    from repro_torch.models import sharding as shd
    from repro_torch.models.moe import moe_apply
    from repro_torch.models.params import gather_params, shard_params
    from repro_torch.models.quantize import _pack_leaf
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    from repro_torch.runtime.pipeline import pipelined_apply
    from repro_torch.serving import BatchScheduler, Request

    data = dict(np.load(path))
    t = lambda k: torch.tensor(data[k])  # noqa: E731
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    res: dict = {}

    # -- the shard_map twin ---------------------------------------------------
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    blocks = shd.shard_map(lambda b: b * 2 + 1, mesh, (shd.P("data", "model"),),
                           shd.P("data", "model"))(x)
    summed = shd.shard_map(lambda b: shd.all_reduce(b, mesh, "model"), mesh,
                           (shd.P("data", "model"),), shd.P("data", None))(x)
    res["shard_map"] = (_np(blocks), _np(summed))
    res["shard_leaf"] = _np(shd.shard_leaf(mesh, x, ("embed", "mlp")))
    res["coord"] = (shd.axis_index(mesh, "data"), shd.axis_index(mesh, "model"))

    # -- constrain: a slice of a whole tensor, a re-layout of a placed one ----
    crules = shd.rules_for_mesh(mesh)
    block = shd.constrain(x, ("batch", "vocab"), crules)       # P(data, model)
    moved = shd.constrain(block, ("vocab", "batch"), crules)   # P(model, data)
    whole = shd.constrain(moved, (None, None), crules)
    res["constrain"] = (_np(block), tuple(shd.placement(block).spec),
                        shd.placement(block).shape, _np(moved),
                        tuple(shd.placement(moved).spec),
                        shd.constrain(moved, ("vocab", "batch"), crules) is moved,
                        _np(whole))

    # -- gather_dequant_leaf, both TP patterns --------------------------------
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    leaf = _pack_leaf(t("gd_w"), scfg)
    res["gd_want"] = _np(fake_quantize_array(t("gd_w"), scfg))
    for pattern in ("col", "row"):
        res[f"gd_{pattern}"] = _np(gather_dequant_leaf(leaf, scfg, mesh, pattern, 64,
                                                       dtype=torch.float32))

    # -- the expert-parallel MoE body, dense and packed -----------------------
    mcfg = get_smoke_config("qwen3_moe_235b_a22b")
    mp_ = unflatten(data, "moe_params")
    x = t("moe_x")
    res["moe_dense"] = [_np(v) if isinstance(v, torch.Tensor) else v for v in
                        (*moe_apply(mp_, x, mcfg), *moe_apply(mp_, x, mcfg, mesh=mesh))]
    kcfg = StruMConfig(method="mip2q", p=0.5, L=5, w=16)
    pcfg = dataclasses.replace(mcfg, strum=kcfg)
    pk = engine.build_plan({"blocks": {"moe": unflatten(data, "moe_params32")}},
                           cfg=kcfg, device="cpu").params["blocks"]["moe"]
    res["moe_packed"] = [_np(v) for v in (*moe_apply(pk, x, pcfg),
                                          *moe_apply(pk, x, pcfg, mesh=mesh))]
    # a mesh-aware plan's stacks on an FSDP-only mesh: the local path, the
    # blocks gathered packed
    from torch.distributed.device_mesh import init_device_mesh
    fmesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    fplan = engine.build_plan({"blocks": {"moe": unflatten(data, "moe_params32")}},
                              cfg=kcfg, mesh=fmesh, device="cpu")
    res["moe_fsdp_only"] = (fplan.summary()["variant_distribution"],
                            *[_np(v) for v in moe_apply(fplan.params["blocks"]["moe"],
                                                        x, pcfg, mesh=fmesh)])

    # -- GPipe over pp = 4 -----------------------------------------------------
    pmesh = make_host_mesh(pp=world, data=1, model=1, device="cpu")
    ws = t("pp_ws")
    res["pp"] = _np(pipelined_apply(lambda w, v: torch.tanh(v @ w), ws, t("pp_x"),
                                    mesh=pmesh, n_micro=4))

    # -- the train step on the mesh (the train layout; the ZeRO-3 step for
    # Qwen3-MoE at capacity factor 1) against the single-device step (f32
    # activations), and at the config's own dtype against the reference ----
    qcfg = get_smoke_config("qwen2_7b")
    defs = model_defs(qcfg)
    qp = unflatten(data, "qwen_params")
    ocfg = adamw.AdamWConfig(lr=1e-3, total_steps=10)
    rules = shd.rules_for_mesh(mesh)
    b0 = {k: t(f"batch0_{k}").long() for k in ("tokens", "labels")}
    _, _, m0 = make_train_step(qcfg, ocfg, mesh=mesh, rules=rules)(
        shard_params(qp, defs, mesh, rules),
        adamw.init_opt_state(shard_params(qp, defs, mesh, rules)), b0)
    res["train_loss_config_dtype"] = float(m0["loss"])
    # OLMo's smoke config for the step-by-step parity: Qwen2's k bias has an
    # exactly-zero gradient (softmax ignores a shift of all of a query's
    # scores), so AdamW turns its rounding noise into +-lr steps in any run
    ocfg_t = dataclasses.replace(get_smoke_config("olmo_1b"), dtype="float32")
    odefs = model_defs(ocfg_t)
    from repro_torch.models.params import init_params
    op0 = init_params(odefs, seed=0, device="cpu", dtype_override="float32")
    batches = [{k: t(f"batch{s}_{k}").long() for k in ("tokens", "labels")}
               for s in range(3)]
    one = make_train_step(ocfg_t, ocfg)
    zero = make_train_step(ocfg_t, ocfg, mesh=mesh, rules=rules)
    p1, o1 = op0, adamw.init_opt_state(op0)
    p3 = shard_params(op0, odefs, mesh, rules)
    o3 = adamw.init_opt_state(p3)
    res["train_loss"] = []
    for b in batches:
        p1, o1, m1 = one(p1, o1, b)
        p3, o3, m3 = zero(p3, o3, b)
        res["train_loss"].append((float(m1["loss"]), float(m3["loss"]),
                                  float(m1["grad_norm"]), float(m3["grad_norm"])))
    state = elastic.global_state({"params": p3, "opt": o3}, odefs, mesh, rules)
    res["train_single"] = flatten({"params": p1, "m": o1.m, "v": o1.v})
    res["train_zero3"] = flatten({"params": state["params"], "m": state["opt"].m,
                                  "v": state["opt"].v})
    res["train_local_bytes"] = sum(v.numel() for v in flatten_t(p3).values())
    res["train_global_bytes"] = sum(v.numel() for v in flatten_t(p1).values())
    # the ZeRO-3 step (steps._zero3_step, a yardstick beside the train
    # layout) on Qwen3-MoE's smoke config at capacity factor 1, so capacity
    # drops tokens: slots and load-balance fractions over the whole batch,
    # as on one device; and OLMo's train layout with gradient compression
    mcfg_t = dataclasses.replace(mcfg, dtype="float32", capacity_factor=1.0)
    res["train_moe"] = zero3_vs_one(
        mcfg_t, init_params(model_defs(mcfg_t), seed=0, device="cpu",
                            dtype_override="float32"), batches, ocfg, mesh, rules,
        zero3=True)
    res["train_compressed"] = zero3_vs_one(ocfg_t, op0, batches, ocfg, mesh, rules,
                                           compress=True)
    # the MoE config at its own dtype against the reference's sharded step
    _, _, m0 = make_train_step(mcfg, ocfg, mesh=mesh, rules=rules)(
        shard_params(unflatten(data, "qmoe_params"), model_defs(mcfg), mesh, rules),
        adamw.init_opt_state(shard_params(unflatten(data, "qmoe_params"),
                                          model_defs(mcfg), mesh, rules)), b0)
    res["train_moe_loss_config_dtype"] = (float(m0["loss"]), float(m0["aux"]))
    # the train layout at capacity factor 1 (tokens drop, each data rank
    # routing its rows with its own capacity), f32, against the
    # reference's sharded step
    _, _, m0 = make_train_step(mcfg_t, ocfg, mesh=mesh, rules=rules)(
        shard_params(unflatten(data, "qmoe_params"), model_defs(mcfg_t), mesh, rules),
        adamw.init_opt_state(shard_params(unflatten(data, "qmoe_params"),
                                          model_defs(mcfg_t), mesh, rules)), b0)
    res["train_moe_c1"] = (float(m0["loss"]), float(m0["aux"]))

    # -- elastic: saved on data=2 x model=2, restored on data=4 and one device
    if rank == 0:
        ckpt.save(workdir, 3, state)
    dist.barrier()
    template = {"params": op0, "opt": adamw.init_opt_state(op0)}
    restored, step, _ = ckpt.restore(workdir, template)
    res["restored_step"] = step
    got, want = flatten_t(restored), flatten_t(state)
    res["restored_equal"] = got.keys() == want.keys() and all(
        torch.equal(got[k], want[k]) for k in want)
    mesh4 = make_host_mesh(data=world, model=1, device="cpu")
    rules4 = shd.rules_for_mesh(mesh4)
    loc4 = elastic.local_state(restored, odefs, mesh4, rules4)
    p4, o4, m4 = make_train_step(ocfg_t, ocfg, mesh=mesh4, rules=rules4)(
        loc4["params"], loc4["opt"], batches[0])
    p5, o5, m5 = one(restored["params"], restored["opt"], batches[0])
    res["elastic"] = (float(m4["loss"]), float(m5["loss"]),
                      flatten({"params": gather_params(p4, odefs, mesh4, rules4)}),
                      flatten({"params": p5}))

    # -- packed decode on 2 x 2 against the dense fake-quant decode -----------
    dcfg = StruMConfig(method="mip2q", p=0.5, L=7)
    base = dataclasses.replace(qcfg, dtype="float32")
    cfg = dataclasses.replace(base, strum=dcfg)
    fakeq = engine.fake_quantize(qp, policy=default_policy(dcfg), baseline_int8=False,
                                 device="cpu")
    toks = torch.ones((2, 8), dtype=torch.long)
    _, caches = prefill(fakeq, {"tokens": toks}, base)
    caches = serve_mod.pad_caches(caches, 4)
    tok = torch.ones((2, 1), dtype=torch.long)
    lg_ref, _ = decode_step(fakeq, tok, {k: {n: c.clone() for n, c in v.items()}
                                         for k, v in caches.items()}, 8, base)
    # the sharded serving layout: a mesh-aware plan, every input at its spec
    drules = shd.rules_for_mesh(mesh, 2)
    mplan = engine.build_plan(qp, cfg=dcfg, mesh=mesh, rules=drules, device="cpu")
    placed = place_inputs(cfg, ShapeSpec("decode_2x12", 12, 2, "decode"),
                          (mplan.params, tok, caches, 8), mesh, drules)
    lg_pk, _ = decode_step(*placed, cfg, mesh=mesh, rules=drules)
    res["decode"] = (_np(lg_ref), _np(shd.gather_whole(lg_pk, mesh)))
    # a mesh-less plan in the same layout: its whole packed leaves are cut
    # to this rank's block per use
    served = engine.build_plan(qp, cfg=dcfg, device="cpu").params
    placed = place_inputs(cfg, ShapeSpec("decode_2x12", 12, 2, "decode"),
                          (served, tok, caches, 8), mesh, drules)
    lg_ml, _ = decode_step(*placed, cfg, mesh=mesh, rules=drules)
    res["decode_meshless"] = _np(shd.gather_whole(lg_ml, mesh))

    # -- BatchScheduler(mesh=) against the single-device scheduler ------------
    ocfg_s = get_smoke_config("olmo_1b")
    oscfg = StruMConfig(method="mip2q", p=0.5, L=5)
    ocfg_s = dataclasses.replace(ocfg_s, strum=oscfg)
    from repro_torch.models.params import init_params
    op = init_params(model_defs(ocfg_s), seed=0, device="cpu", dtype_override="float32")
    kv = StruMConfig(method="mip2q", p=0.5, q=4, L=7)
    prompts = [t("sched_prompt0").long(), t("sched_prompt1").long()]

    def run(sched, force=None):
        for i, pr in enumerate(prompts):
            sched.submit(Request(uid=i, prompt=pr, max_new_tokens=6,
                                 force_tokens=None if force is None else force[i]))
        return [r.output for r in sorted(sched.run_to_completion(),
                                         key=lambda r: r.uid)]
    plan1 = build_serving_plan(op, cfg=oscfg, device="cpu")
    want = run(BatchScheduler(ocfg_s, op, n_slots=2, max_len=48, plan=plan1,
                              kv_cache=kv, device="cpu"))
    plan_m = build_serving_plan(op, cfg=oscfg, mesh=mesh, rules=rules, device="cpu")
    got = run(BatchScheduler(ocfg_s, op, n_slots=2, max_len=48, mesh=mesh, rules=rules,
                             plan=plan_m, kv_cache=kv, device="cpu"), force=want)
    res["sched"] = (want, got, plan_m.summary()["variant_distribution"])

    # -- the paged layout and the dense decoders' train layout on 2 x 2 -------
    res["paged_mesh"] = paged_mesh_cases(data, mesh)
    res["tp_train"] = tp_train_cases(data, mesh)
    res["rows"] = (shd.axis_index(mesh, "data"), shd.axis_index(mesh, "model"))

    # -- serve --mesh 2x2 against serve on one device -------------------------
    argv = ["--arch", "olmo_1b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "8", "--gen", "3"]
    a = serve_mod.run(argv)
    b = serve_mod.run(argv + ["--mesh", "2x2"])
    res["serve"] = (a["tokens"].tolist(), b["tokens"].tolist(),
                    b["plan"].summary()["variant_distribution"],
                    serve_mod.report(b)[1])
    return res


#: the paged layout's families: dense, MoE, SSM and the hybrid (smoke configs)
PAGED_ARCHS = ("olmo_1b", "qwen3_moe_235b_a22b", "mamba2_780m", "jamba_1_5_large_398b")


def paged_mesh_cases(data: dict, mesh) -> dict:
    """``BatchScheduler(mesh=)`` on 2 x 2 against one device's, per
    :data:`PAGED_ARCHS` smoke config at f32 and prefill mode: 4 slots, the
    three ``paged_prompt*`` requests, 6 new tokens; the mesh run
    teacher-forced with one device's tokens.  Returns per ``arch/mode``: both
    runs' tokens, their lane logits (the decode lane's gathered whole), the
    rows each decode call of attention and of the SSM mixer was handed
    beside the rows of the page table it got, and both runs' final pools
    and hot state."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import mamba2, model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import BatchScheduler, Request

    prompts = [torch.tensor(data[f"paged_prompt{i}"]).long() for i in range(3)]
    rules = shd.rules_for_mesh(mesh)
    seen: list = []
    attn0, ssm0 = attn_mod.decode_attention_paged, mamba2.ssm_decode

    def attn_probe(p, x, cfg, pool, tails, spec, page_table, cache_len, **kw):
        seen.append(("attn", x.shape[0], _np(page_table)))
        return attn0(p, x, cfg, pool, tails, spec, page_table, cache_len, **kw)

    def ssm_probe(p, x, cfg, cache, **kw):
        seen.append(("ssm", x.shape[0], cache[0].shape[0]))
        return ssm0(p, x, cfg, cache, **kw)

    def lanes(sched, log):
        for name in ("_decode", "_chunk_prefill", "_prefill"):
            lane = getattr(sched, name)

            def run(*a, lane=lane, name=name):
                out = lane(*a)
                table = _np(a[5]) if name == "_decode" else None
                log.append((name, _np(shd.gather_whole(out[0], mesh)), table))
                return out
            setattr(sched, name, run)

    res = {}
    attn_mod.decode_attention_paged, mamba2.ssm_decode = attn_probe, ssm_probe
    try:
        for arch in PAGED_ARCHS:
            cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
            params = tree_from(data, model_defs(cfg), f"paged_{arch}")
            for mode in ("chunked", "serial"):
                out = {}
                for name, m in (("one", None), ("mesh", mesh)):
                    sched = BatchScheduler(cfg, params, n_slots=4, max_len=64, mesh=m,
                                           rules=rules if m is not None else None,
                                           prefill=mode, device="cpu")
                    log: list = []
                    lanes(sched, log)
                    del seen[:]
                    moved = tfm.lane_gather_bytes["decode"]
                    force = out.get("tokens_one")
                    for i, pr in enumerate(prompts):
                        sched.submit(Request(uid=i, prompt=pr, max_new_tokens=6,
                                             force_tokens=None if force is None
                                             else force[i]))
                    done = sorted(sched.run_to_completion(), key=lambda r: r.uid)
                    out[f"tokens_{name}"] = [r.output for r in done]
                    out[f"lanes_{name}"] = log
                    out[f"seen_{name}"] = list(seen)
                    out[f"pools_{name}"] = {k: _np(v) for k, v in
                                            flatten_t(sched.pools).items()
                                            if isinstance(v, torch.Tensor)}
                    out[f"hot_{name}"] = {k: _np(v) for k, v in
                                          flatten_t(sched.hot).items()}
                    out[f"gathered_{name}"] = (tfm.lane_gather_bytes["decode"] - moved,
                                               sched.lane_runs["decode"])
                res[f"{arch}/{mode}"] = out
    finally:
        attn_mod.decode_attention_paged, mamba2.ssm_decode = attn0, ssm0
    return res


def collective_fd_case(mesh) -> dict:
    """The collectives' transposes against central finite differences, in
    f64 on this rank of 2 x 2: ``L = (all_reduce(sum(c_r · tanh(all_gather(x_r))))
    + all_reduce(sum(d_r · grad_all_reduce(v))))**2`` over ``model``, ``x_r``
    this rank's block, ``v`` equal on the ranks of a ``model`` group, ``c_r``
    and ``d_r`` each rank's own, so ``L`` is one value on the group.  Returns
    autograd's gradients of ``x`` and ``v`` and the finite differences: ``x``
    perturbed on one rank of the group at a time, ``v`` on all of it."""
    from repro_torch.models import sharding as shd
    gen = torch.Generator().manual_seed(11 + dist_rank())
    x = torch.randn(2, 3, generator=gen, dtype=torch.float64)
    c = torch.randn(4, 3, generator=gen, dtype=torch.float64)
    d = torch.randn(3, generator=gen, dtype=torch.float64)
    v = torch.tensor([0.3, -0.7, 1.1], dtype=torch.float64)
    me = shd.axis_index(mesh, "model")

    def loss(x, v):
        h = torch.sum(c * torch.tanh(shd.all_gather(x, mesh, "model", 0)))
        q = torch.sum(d * shd.grad_all_reduce(v, mesh, "model"))
        return (shd.all_reduce(h, mesh, "model") + shd.all_reduce(q, mesh, "model")) ** 2

    xg, vg = x.clone().requires_grad_(), v.clone().requires_grad_()
    gx, gv = torch.autograd.grad(loss(xg, vg), (xg, vg))
    eps = 1e-6
    fx = torch.zeros_like(x)
    for k in range(shd.axis_size(mesh, "model")):
        for i in range(x.numel()):
            step = torch.zeros_like(x).reshape(-1)
            step[i] = eps if k == me else 0.0
            step = step.reshape(x.shape)
            diff = (loss(x + step, v) - loss(x - step, v)) / (2 * eps)
            if k == me:
                fx.reshape(-1)[i] = diff
    fv = torch.zeros_like(v)
    for i in range(v.numel()):
        step = torch.zeros_like(v)
        step[i] = eps
        fv[i] = (loss(x, v + step) - loss(x, v - step)) / (2 * eps)
    return {"x": (gx.numpy(), fx.numpy()), "v": (gv.numpy(), fv.numpy())}


def dist_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def tp_train_cases(data: dict, mesh) -> dict:
    """The dense decoders' train layout on 2 x 2 (OLMo and Qwen2 smoke at
    f32, batch ``batch0``): each rank's loss and gradients beside one
    device's cut to this rank's blocks under the rules; the (K, N) of every
    matmul of one train forward on this rank and on one device, in order
    (the dataflow trace's op events)."""
    import dataclasses

    from repro_torch.analysis.dataflow import trace_dataflow
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import steps as St
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import init_params, shard_params

    rules = shd.rules_for_mesh(mesh)
    batch = {k: torch.tensor(data[f"batch0_{k}"]).long() for k in ("tokens", "labels")}
    local = {k: shd.shard_slice(v, shd.P(rules.table["batch"]), mesh)
             for k, v in batch.items()}
    res = {}
    for arch in ("olmo_1b", "qwen2_7b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        defs = model_defs(cfg)
        whole = init_params(defs, seed=0, device="cpu", dtype_override="float32")
        placed = shard_params(whole, defs, mesh, rules)
        (loss1, _), g1 = St._value_and_grad(whole, batch, cfg)
        (loss, _), g = St._tp_value_and_grad(placed, batch, cfg, mesh, rules)
        want = shard_params(g1, defs, mesh, rules)
        res[f"{arch}/loss"] = (float(loss1), float(loss))
        res[f"{arch}/grads"] = {k: (_np(v), _np(flatten_t(want)[k]))
                                for k, v in flatten_t(g).items()}

        def mms(fn, *args):
            return [tuple(e.inputs[1][0]) for e in trace_dataflow(fn, *args).events
                    if e.kind == "op" and e.name.startswith("aten.mm")
                    and len(e.inputs) == 2]
        res[f"{arch}/mm_one"] = mms(lambda p, b: tfm.forward_train(p, b, cfg), whole, batch)
        res[f"{arch}/mm_rank"] = mms(lambda p, b: tfm.forward_train(p, b, cfg, mesh, rules),
                                     placed, local)
    res["fd"] = collective_fd_case(mesh)
    return res


def zero3_vs_one(cfg, p0, batches, ocfg, mesh, rules, compress=False, zero3=False):
    """``len(batches)`` steps of ``make_train_step(mesh=)`` (the train
    layout), or with ``zero3`` of the ZeRO-3 step (``steps._zero3_step``),
    and as many single-device steps from the same parameters ``p0``:
    ``(per-step metrics as (one device, mesh) pairs, the single-device
    state, the mesh state gathered)``, the states flat, with the
    error-feedback residual under ``ef`` when ``compress``."""
    from repro_torch.launch import steps as St
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_defs
    from repro_torch.models.params import gather_params, shard_params
    from repro_torch.optim import adamw
    from repro_torch.runtime import compression as gcomp
    defs = model_defs(cfg)
    one = make_train_step(cfg, ocfg, grad_compression=compress)
    zero = (St._zero3_step(cfg, ocfg, mesh, rules, compress) if zero3 else
            make_train_step(cfg, ocfg, mesh=mesh, rules=rules, grad_compression=compress))
    pa, pb = p0, shard_params(p0, defs, mesh, rules)
    oa, ob = adamw.init_opt_state(pa), adamw.init_opt_state(pb)
    ea, eb = gcomp.init_ef_state(pa), gcomp.init_ef_state(pb)
    metrics = []
    for b in batches:
        if compress:
            pa, oa, ea, ma = one(pa, oa, ea, b)
            pb, ob, eb, mb = zero(pb, ob, eb, b)
        else:
            pa, oa, ma = one(pa, oa, b)
            pb, ob, mb = zero(pb, ob, b)
        metrics.append({k: (float(ma[k]), float(mb[k]))
                        for k in ("loss", "ce", "aux", "grad_norm")})
    single = {"params": pa, "m": oa.m, "v": oa.v}
    full = {k: gather_params(v, defs, mesh, rules)
            for k, v in (("params", pb), ("m", ob.m), ("v", ob.v))}
    if compress:
        single["ef"] = ea.residual
        full["ef"] = gather_params(eb.residual, defs, mesh, rules)
    return metrics, flatten(single), flatten(full)


def flatten_t(tree, prefix: str = "") -> dict:
    """Nested dicts / NamedTuples of tensors -> ``{"a/b": tensor}``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flatten_t(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ----------------------------------------------- test_torch_dataflow.py --

def dataflow_cases(rank: int, world: int) -> dict:
    """On a 2 x 2 ("data", "model") mesh: ``collective_stats`` of every
    ``sharded:*`` variant (the suite's scenarios, zero payloads) with the
    dataflow findings, and one ``sharded:gather_pallas`` dispatch of a
    mesh-aware plan's leaf through ``all_gather_stats`` beside the runtime
    counters it records."""
    from repro_torch import engine, telemetry
    from repro_torch.analysis import suite
    from repro_torch.core.policy import StruMConfig
    from repro_torch.engine.dispatch import dispatch
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    stats: dict = {}
    report = suite.verify_sharded_variants(mesh=mesh, stats=stats)
    scfg = StruMConfig(method="mip2q", p=0.5, L=5)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(128, 256)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 128)).astype(np.float32))
    plan = engine.build_plan({"mlp": {"wi": {"w": w}}}, cfg=scfg, mesh=mesh,
                             device="cpu")
    leaf = plan.params["mlp"]["wi"]["w"]
    with telemetry.recording() as rec:
        st = telemetry.all_gather_stats(lambda lf, xx: dispatch(lf, xx, mesh=mesh),
                                        leaf, x, mesh=mesh)
    return {"stats": stats, "findings": report.to_json(), "dispatch_stats": st,
            "counters": rec.counters(), "payload": plan.summary()["packed_payload_bytes"]}


# ------------------------------------------ test_torch_mesh_dryrun.py --

#: (case, mesh shape, mesh axis names, shape kind): the live twins of the
#: dry-run's abstract counts (``launch.dryrun.count_step(mesh=)``)
MESH_CASES = (("decode_2x2", (2, 2), ("data", "model"), "decode"),
              ("prefill_2x2", (2, 2), ("data", "model"), "prefill"),
              ("decode_2x1x2", (2, 1, 2), ("pod", "data", "model"), "decode"),
              ("train_data2", (2,), ("data",), "train"),
              ("train_2x2", (2, 2), ("data", "model"), "train"))
MESH_ARCHS = ("olmo_1b", "moonshot_v1_16b_a3b")


def mesh_shape_spec(kind: str):
    """A small cell of ``kind`` (4 sequences, 16 tokens)."""
    from repro_torch.configs.base import ShapeSpec
    return ShapeSpec(f"{kind}_small", 16, 4, kind)


def mesh_cfg(arch: str):
    """``arch``'s smoke config, packed with the default ``StruMConfig``."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.policy import StruMConfig
    return dataclasses.replace(get_smoke_config(arch), strum=StruMConfig())


def _materialize(tree, gen):
    """Seeded CPU tensors of a ``meta`` tree's shapes and dtypes (token ids
    below 256, every smoke vocabulary's size)."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            return (torch.randn(t.shape, generator=gen) * 0.05).to(t.dtype)
        return torch.randint(0, 256, t.shape, generator=gen).to(t.dtype)
    if isinstance(tree, dict):
        return {k: _materialize(v, gen) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(v, gen) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, gen) for v in tree)
    return one(tree)


def mesh_live_count(rank: int, mesh, arch: str, kind: str) -> dict:
    """One step of ``kind`` on this rank of ``mesh`` (real gloo groups, CPU
    tensors drawn alike on every rank, f32 weights, so packed scales are
    f32 on both sides) under the dry-run's ``Counter``:
    the collectives it records, in order, and the kernel calls.  Serving
    runs the card's mesh-aware plan (``backend="cuda"``: on the CPU its
    post-gather kernels are the ``torch`` family) on the inputs placed as
    the dry-run places them (``launch.specs.place_inputs``); a train step
    starts from ZeRO-3 shards of the parameters and fresh AdamW moments."""
    import dataclasses

    from repro_torch.launch.dryrun import Counter, _step_for
    from repro_torch.launch.specs import input_specs, place_inputs
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import shard_params
    from repro_torch.optim import adamw

    cfg = mesh_cfg(arch)
    shape = mesh_shape_spec(kind)
    rules = shd.rules_for_mesh(mesh, shape.global_batch)
    gen = torch.Generator().manual_seed(0)
    inputs = _materialize(input_specs(dataclasses.replace(cfg, strum=None), shape,
                                      param_dtype="float32"), gen)
    if kind == "train":
        defs = model_defs(cfg)
        params = shard_params(inputs[0], defs, mesh, rules, device="cpu")
        inputs = (params, adamw.init_opt_state(params), inputs[2])
    else:
        plan = build_serving_plan(inputs[0], cfg=cfg.strum, backend="cuda", mesh=mesh,
                                  rules=rules, device="cpu")
        inputs = place_inputs(cfg, shape, (plan.params,) + tuple(inputs[1:]), mesh,
                              rules)
    counter = Counter()
    with counter:
        _step_for(cfg, kind, mesh, rules)(*inputs)
    return {"collectives": counter.collectives, "kernels": dict(counter.kernels)}


def mesh_dryrun_cases(rank: int, world: int) -> dict:
    """Every :data:`MESH_CASES` x :data:`MESH_ARCHS` on 4 ranks; rank 0's
    counts (the other ranks return an empty dict).  ``train_data2`` runs on
    ranks {0, 1} and {2, 3}, two data = 2 meshes side by side."""
    from torch.distributed.device_mesh import init_device_mesh
    meshes = {}
    for case, shape, names, _ in MESH_CASES:
        if case == "train_data2":
            pairs = init_device_mesh("cpu", (2, 2), mesh_dim_names=("replica", "data"))
            meshes[case] = pairs["data"]
        else:
            meshes[case] = init_device_mesh("cpu", shape, mesh_dim_names=names)
    res = {}
    for case, _, _, kind in MESH_CASES:
        for arch in MESH_ARCHS:
            out = mesh_live_count(rank, meshes[case], arch, kind)
            if rank == 0:
                res[(case, arch)] = out
    return res


# ------------------------------------------- test_torch_spmd_serving.py --

#: (arch, plan, mesh shape, global batch): the sharded serving layout's
#: cases; batch 3 is one the data axis of 2 does not divide (replicated)
SPMD_CASES = tuple((arch, plan, shape, b)
                   for arch in ("olmo_1b", "qwen2_7b") for plan in ("dense", "mip2q")
                   for shape, b in (((2, 2), 4), ((1, 4), 4), ((4, 1), 4), ((2, 2), 3))
                   ) + (("qwen2_7b_h6", "dense", (1, 4), 4),) + tuple(
    (arch, plan, shape, b)
    for arch, plans in (("moonshot_v1_16b_a3b", ("dense", "mip2q")),
                        ("mamba2_780m", ("dense", "mip2q")),
                        ("mamba2_780m_split", ("dense",)),
                        ("jamba_1_5_large_398b", ("dense",)))
    for plan in plans
    for shape, b in (((2, 2), 4), ((1, 4), 4), ((2, 2), 3)))
#: a case's config name -> (smoke config, overrides): Qwen2's smoke config
#: with 6 query heads over 2 kv heads puts 1.5 heads on each of 4 ranks
#: (the packed plan's 6 ``wo`` blocks do not split over 4: dense only);
#: Mamba-2 also with its split projections (``in_z`` / ``in_x`` / ``in_bc``
#: / ``in_dt``)
SPMD_ARCHS = {"olmo_1b": ("olmo_1b", {}), "qwen2_7b": ("qwen2_7b", {}),
              "qwen2_7b_h6": ("qwen2_7b", {"n_heads": 6, "n_kv_heads": 2}),
              "moonshot_v1_16b_a3b": ("moonshot_v1_16b_a3b", {}),
              "mamba2_780m": ("mamba2_780m", {}),
              "mamba2_780m_split": ("mamba2_780m", {"ssm_split_proj": True}),
              "jamba_1_5_large_398b": ("jamba_1_5_large_398b", {})}
#: prompt length and greedy steps of every case
SPMD_PROMPT, SPMD_GEN = 8, 4


def spmd_case_id(case) -> str:
    arch, plan, shape, b = case
    return f"{arch}-{plan}-{shape[0]}x{shape[1]}-b{b}"


def spmd_cfg(arch: str, plan: str):
    """``arch``'s smoke config at f32 activations, packed with mip2q p = 0.5
    L = 5 for ``plan == "mip2q"``."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.policy import StruMConfig
    base, over = SPMD_ARCHS[arch]
    cfg = dataclasses.replace(get_smoke_config(base), dtype="float32", **over)
    if plan == "mip2q":
        cfg = dataclasses.replace(cfg, strum=StruMConfig(method="mip2q", p=0.5, L=5))
    return cfg


def tree_from(data: dict, defs, prefix: str):
    """The arrays of ``data`` under ``prefix`` shaped like the ``ParamDef``
    tree ``defs`` (empty sub-trees kept), as CPU tensors."""
    if not isinstance(defs, dict):
        return torch.tensor(np.asarray(data[prefix]))
    return {k: tree_from(data, v, f"{prefix}/{k}") for k, v in defs.items()}


def _blocks_flat(tree, prefix: str = "") -> dict:
    """A placed tree's tensors by path; a packed leaf's payload fields."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_blocks_flat({f: v[f] for f in FIELDS} if "mask" in v else v, name))
        elif isinstance(v, torch.Tensor):
            out[name] = _np(v).copy()     # decode steps write caches in place
    return out


def spmd_serving_cases(rank: int, world: int, path: str) -> dict:
    """Every :data:`SPMD_CASES` case on this rank: the placed parameters'
    blocks, the prefill caches' blocks, the logits of the prefill and each
    greedy decode step gathered whole, the tokens; and ``serve``'s tokens
    and logits on the same mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.serve import greedy_tokens, serve
    from repro_torch.launch.specs import padded_cache_len, place_inputs
    from repro_torch.launch.steps import build_serving_plan
    from repro_torch.models import decode_step, model_defs, prefill
    from repro_torch.models import sharding as shd

    data = dict(np.load(path))
    meshes = {shape: init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
              for shape in {c[2] for c in SPMD_CASES}}
    s, gen = SPMD_PROMPT, SPMD_GEN
    res = {}
    for case in SPMD_CASES:
        arch, plan, shape, b = case
        cfg, mesh = spmd_cfg(arch, plan), meshes[shape]
        rules = shd.rules_for_mesh(mesh, b)
        params = tree_from(data, model_defs(cfg), f"w/{arch}")
        if cfg.strum is not None:
            params = build_serving_plan(params, cfg=cfg.strum, mesh=mesh, rules=rules,
                                        device="cpu").params
        prompt = torch.tensor(data[f"prompt/{b}"]).long()
        placed, batch = place_inputs(cfg, ShapeSpec("prefill", s, b, "prefill"),
                                     (params, {"tokens": prompt}), mesh, rules)
        lg, caches = prefill(placed, batch, cfg, mesh=mesh, rules=rules,
                             max_len=padded_cache_len(s + gen))
        out = {"leaves": _blocks_flat(placed), "caches": _blocks_flat(caches),
               "cache_specs": {f"{pos}/{n}": tuple(shd.placement(t).spec)
                               for pos, c in caches.items() for n, t in c.items()}}
        logits = [shd.gather_whole(lg, mesh)[:, -1]]
        tok = greedy_tokens(lg, mesh, cfg.vocab_size)
        toks = [shd.gather_whole(tok, mesh)]
        for i in range(gen):
            lg, caches = decode_step(placed, tok, caches, s + i, cfg, mesh=mesh,
                                     rules=rules)
            logits.append(shd.gather_whole(lg, mesh)[:, -1])
            tok = greedy_tokens(lg, mesh, cfg.vocab_size)
            toks.append(shd.gather_whole(tok, mesh))
        out["logits"] = _np(torch.stack(logits, dim=1))
        out["tokens"] = _np(torch.cat(toks, dim=1))
        st, _, _, sl = serve(cfg, params, prompt, gen, device="cpu", return_logits=True,
                             warmup=False, mesh=mesh, rules=rules)
        out["serve"] = (_np(st), _np(sl))
        res[spmd_case_id(case)] = out
    return res


def spmd_uncovered_cases(rank: int, world: int) -> dict:
    """The lanes that hold whole dense params, on 2 x 2: the MoE family's
    train forward without a mesh, a serving step without a mesh and the
    paged runtime each refuse a sharded dense leaf (the message)."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import forward_train, model_defs, prefill
    from repro_torch.models import sharding as shd
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.serving import BatchScheduler, Request

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = shd.rules_for_mesh(mesh, 4)
    res = {}

    def refused(fn) -> str:
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    olmo = dataclasses.replace(get_smoke_config("olmo_1b"), dtype="float32")
    op = init_params(model_defs(olmo), seed=0, device="cpu", dtype_override="float32")
    sp = shard_params(op, model_defs(olmo), mesh, rules, device="cpu")
    toks = torch.ones((4, 8), dtype=torch.long)
    # the MoE family's train forward without a mesh (whole dense params)
    qmoe = dataclasses.replace(get_smoke_config("qwen3_moe_235b_a22b"), dtype="float32")
    qp = init_params(model_defs(qmoe), seed=0, device="cpu", dtype_override="float32")
    sq = shard_params(qp, model_defs(qmoe), mesh, rules, device="cpu")
    res["train"] = refused(lambda: forward_train(sq, {"tokens": toks}, qmoe))
    res["no_mesh"] = refused(lambda: prefill(sp, {"tokens": toks}, olmo))

    def paged():
        sched = BatchScheduler(olmo, sp, n_slots=2, max_len=32, mesh=mesh, rules=rules,
                               device="cpu")
        sched.submit(Request(uid=0, prompt=toks[0], max_new_tokens=2))
        sched.run_to_completion()
    res["paged"] = refused(paged)
    return res


# --------------------------------- test_torch_family_train_layout.py --

#: the train layout's MoE, SSM and hybrid cases: (case, smoke config,
#: overrides)
FAMILY_CASES = (("qwen3_moe", "qwen3_moe_235b_a22b", {}),
                ("moonshot", "moonshot_v1_16b_a3b", {}),
                ("mamba2", "mamba2_780m", {}),
                ("mamba2_split", "mamba2_780m", {"ssm_split_proj": True}),
                ("jamba", "jamba_1_5_large_398b", {}))
#: the aux-only cases (every label -1): an MoE stack and the hybrid
FAMILY_AUX_ONLY = ("qwen3_moe", "jamba")
#: random directions of the f64 finite-difference case, and its step
FAMILY_FD_DIRECTIONS, FAMILY_FD_EPS = 3, 1e-3


def family_cfg(case: str, get_smoke_config=None, **over):
    """``case``'s smoke config at f32 activations and capacity factor 4
    (``over`` replaces more fields); ``get_smoke_config`` is the package's
    (the port's by default, the reference's in its script)."""
    import dataclasses
    if get_smoke_config is None:
        from repro_torch.configs.base import get_smoke_config
    base, fixed = {c: (a, o) for c, a, o in FAMILY_CASES}[case]
    return dataclasses.replace(get_smoke_config(base), **{
        "dtype": "float32", "capacity_factor": 4.0, **fixed, **over})


def _grad_blocks(cfg, whole, placed, batch, mesh, rules) -> dict:
    """This rank's loss, aux and gradient blocks in the train layout beside
    one device's, cut to the same blocks under the rules."""
    from repro_torch.launch import steps as St
    from repro_torch.models import model_defs
    from repro_torch.models.params import shard_params
    (l1, m1), g1 = St._value_and_grad(whole, batch, cfg)
    (l2, m2), g2 = St._tp_value_and_grad(placed, batch, cfg, mesh, rules)
    want = flatten_t(shard_params(g1, model_defs(cfg), mesh, rules))
    return {"loss": (float(l1), float(l2)), "ce": (float(m1["ce"]), float(m2["ce"])),
            "aux": (float(m1["aux"]), float(m2["aux"])),
            "grads": {k: (_np(v), _np(want[k])) for k, v in flatten_t(g2).items()}}


def _expert_products(cfg, fn, *args) -> list:
    """The weight shapes of the expert contractions (batched products
    against a ``(E, d_model, d_ff)`` or ``(E, d_ff, d_model)`` stack) that
    one call of ``fn`` makes, in order (the dataflow trace's op events)."""
    from repro_torch.analysis.dataflow import trace_dataflow
    stacks = {(cfg.d_model, cfg.d_ff), (cfg.d_ff, cfg.d_model)}
    return [tuple(e.inputs[1][0]) for e in trace_dataflow(fn, *args).events
            if e.kind == "op" and e.name.startswith("aten.bmm") and len(e.inputs) == 2
            and tuple(e.inputs[1][0][1:]) in stacks]


class _Float64:
    """Every ``torch.float32`` the port names (its norms, router, attention,
    the linears' f32 accumulation) read as ``torch.float64`` while entered,
    so a model runs in float64 throughout: the reference's f64 referee does
    the same with ``jnp.float32``."""

    def __enter__(self):
        from repro_torch.models import mamba2
        self.saved = torch.float32, mamba2._F32
        torch.float32 = mamba2._F32 = torch.float64
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba2
        torch.float32, mamba2._F32 = self.saved


def _directional_fd(data: dict, mesh, rules, batch) -> list:
    """Qwen3-MoE's smoke config at capacity factor 1 (tokens drop) in
    float64 in the train layout: for each of :data:`FAMILY_FD_DIRECTIONS`
    seeded directions ``v`` of the whole parameter tree, autograd's
    directional derivative (the gathered gradient dotted with ``v``) and
    the central difference of the mesh step's loss along ``v``."""
    from repro_torch.launch import steps as St
    from repro_torch.models import model_defs
    from repro_torch.models.params import gather_params, shard_params
    out = []
    with _Float64():
        cfg = family_cfg("qwen3_moe", capacity_factor=1.0, dtype="float64")
        defs = model_defs(cfg)
        whole = {k: v.double() for k, v in flatten_t(
            tree_from(data, defs, "p_qwen3_moe")).items()}
        tree = lambda flat: unflatten_t(flat, defs)  # noqa: E731
        (_, _), g = St._tp_value_and_grad(shard_params(tree(whole), defs, mesh, rules),
                                          batch, cfg, mesh, rules)
        g = flatten_t(gather_params(g, defs, mesh, rules))
        rng = np.random.default_rng(3)
        for _ in range(FAMILY_FD_DIRECTIONS):
            v = {k: torch.tensor(rng.normal(size=tuple(t.shape)) * 0.01)
                 for k, t in sorted(whole.items())}
            ad = sum(float(torch.sum(g[k] * v[k])) for k in whole)

            def loss(sign):
                p = tree({k: whole[k] + sign * FAMILY_FD_EPS * v[k] for k in whole})
                (l, _), _ = St._tp_value_and_grad(shard_params(p, defs, mesh, rules),
                                                  batch, cfg, mesh, rules)
                return float(l)
            out.append((ad, (loss(1.0) - loss(-1.0)) / (2 * FAMILY_FD_EPS)))
    return out


def unflatten_t(flat: dict, defs) -> dict:
    """``flatten_t``'s ``{"a/b": tensor}`` back to the tree of ``defs``."""
    def build(d, prefix):
        if not isinstance(d, dict):
            return flat[prefix]
        return {k: build(v, f"{prefix}/{k}" if prefix else k) for k, v in d.items()}
    return build(defs, "")


def _refused_before_collectives(fn) -> str:
    """``fn``'s ValueError message, with every process group of the mesh
    refused while it runs (so the message comes before any collective)."""
    from repro_torch.models import sharding as shd
    group = shd._group

    def no_group(*a):
        raise AssertionError("a collective ran before the refusal")
    shd._group = no_group
    try:
        fn()
    except ValueError as e:
        return str(e)
    finally:
        shd._group = group
    return ""


def family_train_cases(rank: int, world: int, path: str) -> dict:
    """The train layout of the MoE, SSM and hybrid families on 2 x 2 (the
    :data:`FAMILY_CASES` smoke configs, f32, capacity factor 4, weights from
    ``path``): this rank's loss and gradient blocks beside one device's
    (also with every label -1), three ``make_train_step(mesh=)`` steps
    beside three single-device steps, the expert products of one train
    forward on this rank and on one device; Mamba-2's steps with gradient
    compression; Qwen3-MoE's f64 directional derivatives at capacity factor
    1 against finite differences; the steps a ``model`` axis of 2 does not
    divide (3 experts, 1 SSM head), refused."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model_defs
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import init_params, shard_params
    from repro_torch.optim import adamw

    data = dict(np.load(path))
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    rules = shd.rules_for_mesh(mesh)
    batches = [{k: torch.tensor(data[f"batch{s}_{k}"]).long() for k in ("tokens", "labels")}
               for s in range(3)]
    local = {k: shd.shard_slice(v, shd.P(rules.table["batch"]), mesh)
             for k, v in batches[0].items()}
    aux_only = dict(batches[0], labels=torch.full_like(batches[0]["labels"], -1))
    ocfg = adamw.AdamWConfig(lr=1e-3, total_steps=10)
    res: dict = {"coord": (shd.axis_index(mesh, "data"), shd.axis_index(mesh, "model"))}
    for case, _, _ in FAMILY_CASES:
        cfg = family_cfg(case)
        defs = model_defs(cfg)
        whole = tree_from(data, defs, f"p_{case}")
        placed = shard_params(whole, defs, mesh, rules)
        out = _grad_blocks(cfg, whole, placed, batches[0], mesh, rules)
        if case in FAMILY_AUX_ONLY:
            out["aux_only"] = _grad_blocks(cfg, whole, placed, aux_only, mesh, rules)
        out["steps"] = zero3_vs_one(cfg, whole, batches, ocfg, mesh, rules)
        if cfg.n_experts:
            with torch.no_grad():
                out["experts"] = (
                    _expert_products(cfg, lambda p, b: tfm.forward_train(p, b, cfg),
                                     whole, batches[0]),
                    _expert_products(cfg, lambda p, b: tfm.forward_train(
                        p, b, cfg, mesh, rules), placed, local))
        res[case] = out
    cfg = family_cfg("mamba2")
    res["mamba2_compressed"] = zero3_vs_one(
        cfg, tree_from(data, model_defs(cfg), "p_mamba2"), batches, ocfg, mesh, rules,
        compress=True)
    res["fd"] = _directional_fd(data, mesh, rules, batches[0])
    res["refused"] = {}
    for case, over in (("qwen3_moe", {"n_experts": 3}), ("mamba2", {"ssm_head_dim": 128})):
        cfg = family_cfg(case, **over)
        params = init_params(model_defs(cfg), seed=0, device="cpu",
                             dtype_override="float32")
        step = make_train_step(cfg, ocfg, mesh=mesh, rules=rules)
        res["refused"][case] = _refused_before_collectives(
            lambda: step(params, adamw.init_opt_state(params), batches[0]))
    return res
