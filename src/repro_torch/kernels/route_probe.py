"""K11's routes timed against each other on the card.

``strum_page_decode_launch`` picks a route per call: the register path or
the staged path, 4 or 1 channels a thread.  This script builds the shipped
``csrc/strum_attention.cu`` beside copies whose source is edited to pin one
choice, runs every build on the same pages, holds each bit for bit to
``strum_page_decode_plain`` and times them graph-replayed in interleaved
rounds (CUDA events), so each fork of the launcher is shown by a reading
taken in one process on one card:

    shipped   the source as it is
    staged4   the staged path for every codec, 4 channels a thread
    staged1   the staged path for every codec, 1 channel a thread
    t256      256-thread blocks instead of 128
    unroll1   the staged path's position loop not unrolled

    PYTHONPATH=src python -m repro_torch.kernels.route_probe [--rounds 7]

Needs a card and ``nvcc``; the copies are built in parallel under the build
directory (``kernels/build.py``).  The cases are ``chip_smoke.py`` phase
g's (random pages of the same shapes) and two of 160 pages of 128 at w 64
and 128.  On the staged cases (w 64, 128) ``shipped`` and ``staged4`` run
the same code: their gap is the spread.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from repro_torch.core.policy import StruMConfig
from repro_torch.engine.cache import encode_page
from repro_torch.hardware import HBM_BYTES_PER_S
from repro_torch.kernels import build
from repro_torch.kernels.ops import _min1
from repro_torch.kernels.strum_decode import strum_page_decode_plain
from repro_torch.kernels.strum_matmul import METHOD_CODES

_STAGED = ("const bool staged = w > 64 || n_high > 16 || lo_n > 8;",
           "const bool staged = true;")
#: variant -> (old, new) edits of the source, each old text found exactly once
VARIANTS = {
    "shipped": [],
    "staged4": [_STAGED],
    "staged1": [_STAGED, ("const bool vec4 = F % 4 == 0", "const bool vec4 = false")],
    "t256": [("constexpr int kDecodeThreads = 128;", "constexpr int kDecodeThreads = 256;")],
    "unroll1": [("#pragma unroll 4\n      for (int pos = 0; pos < n; ++pos) {",
                 "#pragma unroll 1\n      for (int pos = 0; pos < n; ++pos) {")],
}

# (label, StruMConfig keywords, pages, page size, F)
CASES = [
    ("olmo mip2q", dict(method="mip2q", p=0.5, L=7), 320, 16, 2048),
    ("olmo dliq q=3", dict(method="dliq", p=0.25, q=3), 320, 16, 2048),
    ("qwen2-7b width", dict(method="mip2q", p=0.5, L=7), 320, 16, 512),
    ("olmo pages of 128", dict(method="mip2q", p=0.5, L=7), 40, 128, 2048),
    ("olmo w=64", dict(method="mip2q", w=64, p=0.5, L=7), 40, 128, 2048),
    ("olmo w=128", dict(method="mip2q", w=128, p=0.5, L=7), 40, 128, 2048),
    ("w=64, 160 pages", dict(method="mip2q", w=64, p=0.5, L=7), 160, 128, 2048),
    ("w=128, 160 pages", dict(method="mip2q", w=128, p=0.5, L=7), 160, 128, 2048),
]


def _sources() -> dict:
    text = (build.CSRC / "strum_attention.cu").read_text()
    out = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        out[name] = src
    return out


def _build_all() -> dict:
    """Every variant compiled at once (one nvcc each); name -> library."""
    d = build.build_dir() / "route_probe"
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in _sources().items():
        cu = d / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(d / f"{name}.so"))
        lib.strum_page_decode_launch.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.strum_page_decode_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _launcher(lib, fields, cfg, out):
    mask, hi, lo, scale = fields
    p, nb, _, f = mask.shape

    def call():
        err = lib.strum_page_decode_launch(
            mask.data_ptr(), hi.data_ptr(), lo.data_ptr(), scale.data_ptr(), out.data_ptr(),
            p, nb, cfg.w, f, mask.shape[2], hi.shape[2], lo.shape[2], cfg.n_low, cfg.q,
            METHOD_CODES[cfg.method], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def _graphed(fn):
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def _ms(fn, reps: int = 20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(rounds: int) -> list:
    libs = _build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, cfg_kw, n_pages, ps, f in CASES:
        cfg = StruMConfig(**cfg_kw)
        enc = encode_page(torch.randn((n_pages, ps, f), generator=gen, device="cuda"), cfg)
        pool = {k: v if k == "scale" else _min1(v, 2).contiguous() for k, v in enc.items()}
        fields = [pool[k] for k in ("mask", "hi", "lo", "scale")]
        want = strum_page_decode_plain(*fields, w=cfg.w, n_low=cfg.n_low, q=cfg.q,
                                       method=cfg.method)
        replays, outs = {}, []  # outs: each graph's output, alive while it replays
        for name, lib in libs.items():
            out = torch.full_like(want, float("nan"))
            call = _launcher(lib, fields, cfg, out)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{name} differs from the plain version: {label}")
            replays[name] = _graphed(call)
            outs.append(out)
        times = {name: [] for name in replays}
        for _ in range(rounds):
            for name, replay in replays.items():
                times[name].append(_ms(replay))
        nbytes = sum(t.numel() * t.element_size() for t in fields) + want.numel() * 4
        row = {"case": f"{label}: {n_pages} pages of {ps}, w={cfg.w}, {cfg.method} "
                       f"p={cfg.p} q={cfg.q}, F={f}",
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "ms": {n: statistics.median(v) for n, v in times.items()},
               "range_ms": {n: [min(v), max(v)] for n, v in times.items()}}
        rows.append(row)
        print(f"{row['case']} (exact in every build; bound {row['bound_ms']:.4f} ms):",
              ", ".join(f"{n} {row['ms'][n]:.4f} [{row['range_ms'][n][0]:.4f}, "
                        f"{row['range_ms'][n][1]:.4f}]" for n in times), flush=True)
        del pool, fields, want, replays, outs
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7, help="interleaved timing rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("route_probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else
          torch.cuda.get_device_name(0), flush=True)
    print(json.dumps({"rounds": args.rounds, "cases": run(args.rounds)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
