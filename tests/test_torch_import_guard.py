"""The PyTorch port stands alone: no JAX and nothing of ``repro``, and
nothing of ``repro``'s AARC stack left unported."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_GUARDED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
for last in ("placement", "autoscale", "online"):
    assert f"repro_torch.core.{last}" in names, last
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _GUARDED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 88      # every submodule walked


_CAMPAIGN_IMPORT = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
from repro_torch.core import (AdaptiveCampaign, Campaign, run_adaptive,
                              run_campaign, run_grid_search)
from repro_torch.core.search import (CellEligibility, GridCell, GridReport,
                                     GridResume, grid_eligibility)
import repro_torch.core as core
for name in ("run_grid_search", "Campaign", "run_campaign",
             "AdaptiveCampaign", "run_adaptive"):
    assert name in core.__all__, name
print("ok")
"""


def test_campaign_plane_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CAMPAIGN_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


#: top-level names of ``repro.core`` / ``repro.serverless`` modules that
#: the port renames on purpose (ROADMAP.md, "Not ported, by design"):
#: the reference's name, and the port's counterpart in the same module
RENAMED = {
    "core/engine.py": {"_JAX_SWEEP": "fast_plane_sweep",
                       "_jax_sweep_fn": "fast_plane_sweep"},
    "serverless/platform.py": {"JaxMeasuredOracle": "TorchMeasuredOracle"},
}


def _top_level_names(path: Path) -> set:
    """Functions, classes and assigned names at a module's top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return names


@pytest.mark.parametrize("sub", ["core", "serverless"])
def test_every_reference_name_has_a_counterpart(sub):
    """Every module of ``repro.core`` and ``repro.serverless`` has a
    counterpart in the port defining each of its top-level names, but
    for the renames above."""
    ref_root = ROOT / "src" / "repro"
    missing = {}
    for ref in sorted((ref_root / sub).rglob("*.py")):
        rel = ref.relative_to(ref_root).as_posix()
        port = PORT / rel
        if not port.exists():
            missing[rel] = "module"
            continue
        port_names = _top_level_names(port)
        renamed = RENAMED.get(rel, {})
        assert set(renamed.values()) <= port_names, rel
        gone = sorted(_top_level_names(ref) - port_names - set(renamed))
        if gone:
            missing[rel] = gone
    assert missing == {}


def test_port_sources_import_no_jax_or_repro():
    files = sorted(PORT.glob("**/*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_prefill_profile.py",
        ROOT / "scripts" / "ssd_inter_variants.py",
        ROOT / "scripts" / "torch_train_profile.py",
        ROOT / "scripts" / "cpu_first_call_check.py",
        ROOT / "scripts" / "torch_mesh_check.py",
        ROOT / "examples" / "torch_train_lm.py",
        ROOT / "examples" / "torch_autotune_stage_graph.py",
        ROOT / "examples" / "torch_fleet_sim.py",
        ROOT / "examples" / "torch_serve_workflow.py",
        ROOT / "examples" / "torch_quickstart.py"]
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|repro\b(?!_torch))",
                     re.MULTILINE)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert offenders == []


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"
