"""The port stands alone and never quietly leaves the card.

* No module of ``repro_torch``, and not ``chip_smoke.py``, imports ``jax``
  or ``repro`` (an AST scan, and a subprocess that blocks those imports);
  the draft plans and the telemetry copy among them, whose trace checker
  runs in that state.
* Entry points (serving, and since the training path ``launch.train`` and
  the data pipeline, and since the distributed slice the mesh constructors
  and ``serve --mesh``) default to ``device="cuda"`` and raise without a
  card.
* ``chip_smoke.py`` exits non-zero, printing no result, without a card or
  outside the repo.
* The launch tools (the dry-run, its specs, the H100 constants) and the
  example twins are scanned and import alone; the twins' ``main`` defaults
  to the card and raises without one, while the dry-run (``meta`` tensors)
  needs none.
"""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported(ast.parse(path.read_text())):
        assert mod.split(".")[0] not in FORBIDDEN, (path.name, mod)


BLOCKER = """
import importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    __import__(m)
import chip_smoke
print(len(mods))
"""


def test_all_port_modules_import_with_jax_and_reference_blocked():
    code = BLOCKER.format(forbidden=FORBIDDEN, src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


STANDALONE = ("repro_torch.engine.draft", "repro_torch.telemetry",
              "repro_torch.telemetry.recorder", "repro_torch.telemetry.requests",
              "repro_torch.telemetry.trace", "repro_torch.telemetry.check")


STANDALONE_RUN = """
import importlib, importlib.abc, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {forbidden!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {src!r})
for m in {mods!r}:
    importlib.import_module(m)
sys.argv = ["check", {trace!r}, "--require", "spec:"]
runpy.run_module("repro_torch.telemetry.check", run_name="__main__")
"""


DISTRIBUTED = ("repro_torch.launch.mesh", "repro_torch.models.sharding",
               "repro_torch.engine.sharded", "repro_torch.runtime.pipeline",
               "repro_torch.runtime.elastic")


@pytest.mark.parametrize("mod", DISTRIBUTED)
def test_distributed_modules_are_scanned_and_stand_alone(mod):
    """The distributed slice's modules are among the scanned files and
    import with jax and the reference blocked (no process group starts)."""
    scanned = {str(p.relative_to(ROOT / "src")) for p in _port_files()[:-1]}
    assert mod.replace(".", "/") + ".py" in scanned
    code = STANDALONE_RUN.split("sys.argv")[0].format(
        forbidden=FORBIDDEN, src=str(ROOT / "src"), mods=(mod,))
    code += "import torch.distributed as d; print(d.is_initialized())"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


LAUNCH_TOOLS = ("repro_torch.hardware", "repro_torch.launch.specs",
                "repro_torch.launch.dryrun", "repro_torch.examples.quickstart",
                "repro_torch.examples.serve_batch", "repro_torch.examples.serve_strum",
                "repro_torch.examples.train_e2e", "repro_torch.examples.dryrun_cell")


@pytest.mark.parametrize("mod", LAUNCH_TOOLS)
def test_launch_tools_and_examples_are_scanned_and_stand_alone(mod):
    scanned = {str(p.relative_to(ROOT / "src")) for p in _port_files()[:-1]}
    assert mod.replace(".", "/") + ".py" in scanned
    code = STANDALONE_RUN.split("sys.argv")[0].format(
        forbidden=FORBIDDEN, src=str(ROOT / "src"), mods=(mod,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_draft_and_telemetry_modules_stand_alone(tmp_path):
    """The draft plans and the telemetry copy are scanned above, import with
    jax and the reference blocked, and the trace checker runs as a module
    in that state."""
    scanned = {str(p.relative_to(ROOT / "src")) for p in _port_files()[:-1]}
    for mod in STANDALONE:
        path = mod.replace(".", "/")
        assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned, mod
    trace = tmp_path / "t.json"
    trace.write_text('{"traceEvents": [{"ph": "X", "name": "spec:verify", '
                     '"ts": 0, "dur": 1}]}')
    code = STANDALONE_RUN.format(forbidden=FORBIDDEN, src=str(ROOT / "src"),
                                 mods=STANDALONE, trace=str(trace))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK ") and "spec:=1" in out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.engine import build_plan
    from repro_torch.launch import serve
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    cfg = get_smoke_config("olmo_1b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(model_defs(cfg))
    params = init_params(model_defs(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        build_plan(params)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve(cfg, params, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "olmo_1b", "--smoke"])
    # asked for explicitly, the CPU serves through the torch family
    plan = build_plan(params, device="cpu")
    assert set(plan.variants().values()) == {"torch:dequant"}


def test_train_entry_points_raise_without_a_card(no_card, tmp_path):
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "olmo_1b", "--smoke", "--steps", "1",
                    "--workdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        global_batch(DataConfig(vocab_size=256, seq_len=8, global_batch=2), 0)
    # asked for explicitly, the CPU trains
    assert train.main(["--arch", "olmo_1b", "--smoke", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--ckpt-every", "0", "--device", "cpu",
                       "--workdir", str(tmp_path)]) == 0
    assert not (tmp_path / "ckpt").exists()


def test_paged_entry_points_raise_without_a_card(no_card):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model_defs
    from repro_torch.models.params import init_params
    from repro_torch.serving import BatchScheduler
    cfg = get_smoke_config("olmo_1b")
    params = init_params(model_defs(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchScheduler(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve_paged(cfg, params, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "olmo_1b", "--smoke", "--paged", "--kv-cache", "dliq"])
    # asked for explicitly, the CPU serves through the torch family
    sched = BatchScheduler(cfg, params, device="cpu", kv_cache="fp")
    assert sched.cache_stats()["codec"] == "cache:fp_passthrough"


def test_mesh_entry_points_raise_without_a_card(no_card):
    """``make_host_mesh`` and ``serve --mesh`` default to the card (NCCL)
    and raise before starting a process group; ``device="cpu"`` is gloo."""
    import torch.distributed as dist

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="cuda"):
        make_host_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "olmo_1b", "--smoke", "--mesh", "1x1"])
    assert not dist.is_initialized()


def test_moe_entry_points_raise_without_a_card(no_card):
    from repro_torch.launch import serve
    for extra in ([], ["--paged", "--kv-cache", "dliq"]):
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", "moonshot_v1_16b_a3b", "--smoke"] + extra)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    for cwd, script in [(ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, Path(shutil.copy(ROOT / "chip_smoke.py", tmp_path)))]:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_example_twins_default_to_the_card(no_card, tmp_path, capsys):
    from repro_torch.examples import (dryrun_cell, quickstart, serve_batch,
                                      serve_strum, train_e2e)
    for mod, argv in ((quickstart, []), (serve_batch, ["--arch", "olmo_1b"]),
                      (serve_strum, ["--arch", "olmo_1b"]),
                      (train_e2e, ["--small", "--steps", "1",
                                   "--workdir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main(argv)
    assert not any(tmp_path.iterdir())
    # the dry-run runs on meta tensors: no card needed
    assert dryrun_cell.main(["--arch", "mamba2_780m", "--shape", "long_500k"]) == 0
    assert '"status": "OK"' in capsys.readouterr().out
