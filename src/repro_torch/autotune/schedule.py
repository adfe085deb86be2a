"""Serializable per-layer StruM deployment schedules (a torch-free copy of
``repro.autotune.schedule``: the same class, the same JSON text, so each
package loads the schedules the other writes).

A :class:`StruMSchedule` is the compiler artifact of the paper's
dynamically-configurable PE (Fig. 9): the per-layer table the compiler
"programs before each layer execution".  It maps parameter names to their
chosen :class:`StruMConfig` (or ``None`` = stay plain INT8), round-trips
through JSON for deployment, and *lowers* to a :class:`LayerPolicy` so the
entire existing encode/pack/serve stack consumes it unchanged:

    schedule = search.search_schedule(params, budget=...)   # offline
    schedule.save("sched.json")                             # ship it
    ...
    schedule = StruMSchedule.load("sched.json")             # serving host
    plan = engine.build_plan(params, schedule=schedule)     # pack + select

The JSON form is versioned and self-contained (configs stored as plain
dicts, exclusions + provenance metadata alongside) so a schedule written by
one build remains loadable by the next.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

from repro_torch.core.policy import DEFAULT_EXCLUDE, LayerPolicy, StruMConfig

__all__ = [
    "SCHEDULE_VERSION",
    "config_to_dict", "config_from_dict", "config_key",
    "StruMSchedule",
]

SCHEDULE_VERSION = 1


def config_to_dict(cfg: Optional[StruMConfig]) -> Optional[dict]:
    """JSON-safe dict form of a config (``None`` stays ``None`` = INT8)."""
    if cfg is None:
        return None
    return {"method": cfg.method, "w": cfg.w, "p": cfg.p,
            "q": cfg.q, "L": cfg.L}


def config_from_dict(d: Optional[dict]) -> Optional[StruMConfig]:
    if d is None:
        return None
    return StruMConfig(method=d["method"], w=int(d["w"]), p=float(d["p"]),
                       q=int(d["q"]), L=int(d["L"]))


def config_key(cfg: Optional[StruMConfig]) -> str:
    """Stable short id for grid/cache keys, e.g. ``mip2q/w16/p0.5/L5``."""
    if cfg is None:
        return "int8"
    tail = f"L{cfg.L}" if cfg.method == "mip2q" else f"q{cfg.q}"
    return f"{cfg.method}/w{cfg.w}/p{cfg.p:g}/{tail}"


@dataclasses.dataclass
class StruMSchedule:
    """Per-tensor config assignment + provenance metadata.

    assignments — {parameter name: StruMConfig | None}.  ``None`` means the
                  tensor was profiled but stays plain INT8 (the per-layer
                  fallback the configurable PE exists for).  Names absent
                  from the table are untouched (dense / excluded).
    exclude     — name patterns never quantized, carried into the lowered
                  policy (defaults to the repo-wide DEFAULT_EXCLUDE).
    meta        — free-form provenance: budget, grid, per-tensor SQNR/bytes
                  rows, achieved totals.  Round-trips through JSON.
    """

    assignments: dict[str, Optional[StruMConfig]]
    exclude: tuple = DEFAULT_EXCLUDE
    meta: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------ lowering --
    def to_policy(self) -> LayerPolicy:
        """Lower to a LayerPolicy whose overrides pin each named tensor.

        Overrides outrank exclusions in ``LayerPolicy.resolve``, so a
        schedule entry wins even for names an exclude pattern would catch —
        the schedule is the compiler's explicit word.  Tensors without an
        entry fall through to the exclusion list and a ``None`` default
        (dense), i.e. a schedule fully determines what gets packed.
        """
        overrides = tuple((f"^{re.escape(name.lower())}$", cfg)
                          for name, cfg in self.assignments.items())
        return LayerPolicy(default=None, exclude=tuple(self.exclude),
                           overrides=overrides)

    def resolve(self, name: str) -> Optional[StruMConfig]:
        return self.assignments.get(name)

    # ------------------------------------------------------------- summary --
    def achieved_ratio(self, sizes: Optional[dict] = None) -> float:
        """Bytes-weighted compression vs INT8 over the assigned tensors.

        ``sizes`` maps name → element count; falls back to the sizes the
        search recorded in ``meta["tensors"]``.
        """
        if sizes is None:
            sizes = {r["name"]: r["size"] for r in self.meta.get("tensors", ())}
        tot = 0
        comp = 0.0
        for name, cfg in self.assignments.items():
            n = sizes.get(name)
            if n is None:
                continue
            tot += n
            comp += n * (cfg.compression_ratio if cfg is not None else 1.0)
        return comp / max(tot, 1)

    def summary(self) -> dict:
        dist: dict = {}
        for cfg in self.assignments.values():
            k = config_key(cfg)
            dist[k] = dist.get(k, 0) + 1
        return {"n_tensors": len(self.assignments),
                "config_distribution": dist,
                "achieved_ratio": self.achieved_ratio(), **{
                    k: self.meta[k] for k in ("budget", "weighted_sqnr_db")
                    if k in self.meta}}

    # ---------------------------------------------------------------- JSON --
    def to_json(self) -> str:
        doc = {
            "version": SCHEDULE_VERSION,
            "exclude": list(self.exclude),
            "assignments": {name: config_to_dict(cfg)
                            for name, cfg in self.assignments.items()},
            "meta": self.meta,
        }
        return json.dumps(doc, indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "StruMSchedule":
        doc = json.loads(text)
        ver = doc.get("version", 0)
        if ver > SCHEDULE_VERSION:
            raise ValueError(f"schedule version {ver} is newer than "
                             f"supported {SCHEDULE_VERSION}")
        return cls(
            assignments={name: config_from_dict(d)
                         for name, d in doc.get("assignments", {}).items()},
            exclude=tuple(doc.get("exclude", DEFAULT_EXCLUDE)),
            meta=doc.get("meta", {}),
        )

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "StruMSchedule":
        with open(path) as f:
            return cls.from_json(f.read())
