"""The port stands alone and runs on the card unless told otherwise:
no file under src/repro_torch imports jax or the reference package, the
entry points default to CUDA and refuse to start without a card, and
chip_smoke.py fails without one."""

import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import LM, build_model
from repro_torch.runtime import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_entry_points_default_to_the_card():
    for fn in (resolve_device, LM.__init__, build_model,
               convert.params_from_jax, convert.cache_from_jax):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_construction_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("codeqwen1.5-7b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({"stages": []})
    assert LM(cfg, device="cpu").device.type == "cpu"


def _run_smoke(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
