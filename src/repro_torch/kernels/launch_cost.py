"""Host time a kernel wrapper takes per call on the card, tree against tree.

The port's decode is host-bound (``chip_smoke.py`` phase h's device busy
share), so what a wrapper does in Python before its kernel launches is on
the critical path.  This script times three wrappers at OLMo-1B's decode
shapes: K1 (``strum_matmul_onehot``, phase d's M = 4 bf16 linears, 2048 ->
8192 and 8192 -> 2048, the default plan's mip2q p = 0.5 L = 5), K4
(``strum_paged_attention``, phase h's tick: 4 slots, 16 heads of 128, 12
page slots of 16, 8 sealed, mip2q L = 7 pages) and K11
(``strum_page_decode``, phase g's 320 such pages of 16 x 2048).  Each
round issues ``--calls`` back-to-back calls and reads the host clock around
them, with no sync inside (the device queue stays far from full); the
median of ``--rounds`` rounds is the host time a call.  Beside it, the
device's time a call (CUDA events around the same loop): the kernels' own
time where they are the slower side, else the pace the host sets.

    python -m repro_torch.kernels.launch_cost [--trees DIR DIR ...]

With ``--trees`` each directory's ``src`` is measured in a process of its
own (its own ``repro_torch``), in the order given, e.g. ``parent . .
parent``; the processes share one build directory, so the kernel sources
must be the same.  The last line is the JSON of every run.  Needs a card
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _cases(torch, dev) -> dict:
    """name -> a call of one wrapper on the card at its decode shape."""
    from repro_torch.core.apply import pack_array
    from repro_torch.core.policy import StruMConfig
    from repro_torch.engine.cache import encode_page
    from repro_torch.kernels import strum_attention as A
    from repro_torch.kernels import strum_decode as D
    from repro_torch.kernels import strum_matmul as K
    wcfg = StruMConfig(method="mip2q", p=0.5, L=5)     # the default plan's weights
    cfg = StruMConfig(method="mip2q", p=0.5, L=7)      # phase h's KV pages
    kw = dict(w=cfg.w, n_low=cfg.n_low, q=cfg.q, method=cfg.method)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k_in, n_out in ((2048, 8192), (8192, 2048)):
        pk = pack_array(torch.randn(k_in, n_out, generator=gen), wcfg)
        f = [t.to(dev) for t in (pk.mask, pk.hi, pk.lo, pk.scale)]
        x = torch.randn(4, k_in, generator=gen).to(dev, torch.bfloat16)
        out[f"K1 M=4 {k_in}->{n_out}"] = (
            lambda x=x, f=f: K.strum_matmul_onehot(x, *f, L=wcfg.L, **kw))
    enc = encode_page(torch.randn(2, 64, 16, 2048, generator=gen), cfg)
    k = [enc[n][0].to(dev).contiguous() for n in ("mask", "hi", "lo", "scale")]
    v = [enc[n][1].to(dev).contiguous() for n in ("mask", "hi", "lo", "scale")]
    table = torch.arange(48, dtype=torch.int32).reshape(4, 12)
    table[:, 10:] = -1
    table, n_valid = table.to(dev), torch.full((4,), 8, dtype=torch.int32, device=dev)
    q4 = torch.randn(4, 16, 1, 128, generator=gen).to(dev)
    out["K4 4 slots x 12 pages"] = lambda: A.strum_paged_attention(
        q4, *k, *v, table, n_valid, **kw)
    pages = encode_page(torch.randn(320, 16, 2048, generator=gen), cfg)
    p = [pages[n].to(dev).contiguous() for n in ("mask", "hi", "lo", "scale")]
    out["K11 320 pages"] = lambda: D.strum_page_decode(*p, **kw)
    return out


def measure(rounds: int, calls: int) -> dict:
    import torch
    dev = torch.device("cuda")
    res = {}
    for name, fn in _cases(torch, dev).items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        host, device = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(rounds):
            start.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t1 = time.perf_counter()
            end.record()
            torch.cuda.synchronize()
            host.append((t1 - t0) / calls * 1e6)
            device.append(start.elapsed_time(end) / calls * 1e3)
        res[name] = {"host_us": statistics.median(host), "host_us_rounds": host,
                     "device_us": statistics.median(device)}
    import repro_torch
    return {"package": os.path.dirname(repro_torch.__file__), "cases": res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="*", default=None,
                    help="checkouts to measure, each in its own process, in order")
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("launch_cost needs a CUDA card", file=sys.stderr)
        return 1
    if args.measure or not args.trees:
        print(json.dumps(measure(args.rounds, args.calls)), flush=True)
        return 0
    from repro_torch.kernels import build
    env = {**os.environ, "STRUM_TORCH_BUILD_DIR": str(build.build_dir())}
    runs = []
    for tree in args.trees:
        src = os.path.join(os.path.abspath(tree), "src")
        proc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--measure",
             "--rounds", str(args.rounds), "--calls", str(args.calls)],
            env={**env, "PYTHONPATH": src}, capture_output=True, text=True,
            cwd=os.path.abspath(tree))
        if proc.returncode != 0:
            raise RuntimeError(f"{tree}: {proc.stdout}\n{proc.stderr}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["tree"] = tree
        runs.append(run)
        for name, r in run["cases"].items():
            print(f"{tree:>16}  {name:<24} host {r['host_us']:8.2f} us/call  "
                  f"device {r['device_us']:8.2f} us/call", flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
