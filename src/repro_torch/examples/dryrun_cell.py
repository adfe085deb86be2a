"""Count ONE (arch x shape) cell and print its record (twin of
``examples/dryrun_cell.py``): the single-cell view of
``python -m repro_torch.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.examples.dryrun_cell --arch qwen2_7b \
        --shape decode_32k [--multi-pod]

Departures from the reference script: no ``XLA_FLAGS`` (the port's dry-run
runs the step on ``meta`` tensors, ``launch.dryrun``), and without
``--multi-pod`` the cell is counted on one H100 (mesh ``1x1``), where the
reference's is 16x16; ``--multi-pod`` counts rank 0 of a 2x16x16 mesh.  It
needs no card, so it takes no ``--device``.
"""
from __future__ import annotations

import argparse
import json

__all__ = ["run", "main"]


def run(arch: str = "qwen2_7b", shape: str = "decode_32k",
        multi_pod: bool = False) -> dict:
    """``launch.dryrun.lower_cell``'s record of the cell."""
    from repro_torch.launch.dryrun import lower_cell
    return lower_cell(arch, shape, mesh="2x16x16" if multi_pod else "1x1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.arch, args.shape, args.multi_pod), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
