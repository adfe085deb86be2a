"""Count ONE (arch x shape) cell on one H100 and print its record (twin of
``examples/dryrun_cell.py``): the single-cell view of
``python -m repro_torch.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.examples.dryrun_cell --arch qwen2_7b \
        --shape decode_32k

Departures from the reference script: no ``XLA_FLAGS`` and no
``--multi-pod`` (the port's dry-run is one H100, mesh ``1x1``, and runs the
step on ``meta`` tensors: ``launch.dryrun``).  It needs no card, so it takes
no ``--device``.
"""
from __future__ import annotations

import argparse
import json

__all__ = ["run", "main"]


def run(arch: str = "qwen2_7b", shape: str = "decode_32k") -> dict:
    """``launch.dryrun.lower_cell``'s record of the cell."""
    from repro_torch.launch.dryrun import lower_cell
    return lower_cell(arch, shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--shape", default="decode_32k")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.arch, args.shape), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
