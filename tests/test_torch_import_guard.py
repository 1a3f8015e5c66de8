"""The PyTorch port stands alone: no JAX and nothing of ``repro``."""
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
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _GUARDED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 85      # every submodule walked


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
