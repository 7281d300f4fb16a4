"""The port stands alone: importing every ``repro_torch`` module loads no
``jax`` and nothing of the JAX package, and the entry points refuse to
run without a card unless the caller asks for the CPU."""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Model
from repro_torch.serve import ServeEngine

SRC = Path(__file__).resolve().parent.parent / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print("MODULES", len(names))
print("LOADED", ",".join(bad) or "-")
"""


def test_imports_load_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = dict(line.split(" ", 1) for line in res.stdout.splitlines() if " " in line)
    assert int(lines["MODULES"]) >= 20, res.stdout
    assert lines["LOADED"] == "-", f"repro_torch imported {lines['LOADED']}"


def test_every_module_is_found():
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    for expected in (
        "repro_torch.core.schedule", "repro_torch.parallel.fabric.dense", "repro_torch.kernels.moe_gemm.ops",
        "repro_torch.kernels.flash_attention.ops", "repro_torch.models.transplant", "repro_torch.launch.serve",
        "repro_torch.launch.train", "repro_torch.launch.dryrun", "repro_torch.train.train_step",
        "repro_torch.optim.adamw", "repro_torch.data.pipeline", "repro_torch.core.drift", "repro_torch.core.traffic",
        "repro_torch.kernels.rwkv_wkv.ops", "repro_torch.models.rwkv", "repro_torch.core.runtime",
        "repro_torch.core.selector", "repro_torch.core.faults", "repro_torch.core.bvn", "repro_torch.core.sinkhorn",
        "repro_torch.core.lap", "repro_torch.core.device_controller", "repro_torch.serve.queue",
        "repro_torch.serve.batcher", "repro_torch.serve.metrics", "repro_torch.serve.engine",
        "repro_torch.checkpoint.manager", "repro_torch.optim.compression", "repro_torch.train.loop",
    ):
        assert expected in names


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_raises_without_card_unless_cpu(monkeypatch):
    _no_card(monkeypatch)
    cfg = smoke_config("mixtral-8x7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg, device="cuda")
    assert Model(cfg, device="cpu").device == torch.device("cpu")


def test_serve_entry_point_raises_without_card_unless_cpu(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--smoke", "--batch", "1", "--prompt-len", "8", "--new-tokens", "1", "--rounds", "1"])
    res = serve_mod.main(
        ["--smoke", "--batch", "2", "--prompt-len", "8", "--new-tokens", "2", "--rounds", "1",
         "--controller", "--device", "cpu"]
    )
    assert res.tokens.shape == (1, 2, 2)
    assert torch.isfinite(res.first_logits).all()


def test_serve_rejects_drift_scenarios():
    """Only the scenarios ``core.drift`` defines are accepted."""
    with pytest.raises(SystemExit):
        serve_mod.main(["--smoke", "--drift", "sideways", "--device", "cpu"])


def test_serve_engine_raises_without_card_unless_cpu(monkeypatch):
    _no_card(monkeypatch)
    cfg = smoke_config("mixtral-8x7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, decode_slots=2, max_len=16, buckets=(4,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, decode_slots=2, max_len=16, buckets=(4,), device="cuda")
    eng = ServeEngine(cfg, decode_slots=2, max_len=16, buckets=(4,), device="cpu")
    assert eng.device == torch.device("cpu") and eng.model.device == torch.device("cpu")
