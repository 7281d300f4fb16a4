"""The port's checkpoint manager (``repro_torch.checkpoint``) held to the
JAX package's ``TestCheckpoint`` cases (``tests/test_train_substrate.py``)
and to its on-disk layout, plus what the port adds: restore in place
(parameters keep their storage), bf16 leaves stored as raw words, and a
snapshot that is complete when ``save_async`` returns.

The train-state round trip starts from ``Model.init(PRNGKey(0))`` of the
smoke Mixtral, transplanted into the port in f32.  Everything is compared
exactly: a checkpoint stores the bits it was given.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel

from repro_torch.checkpoint import CheckpointManager, restore, save
from repro_torch.configs import smoke_config
from repro_torch.models.transplant import load_reference
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((4, 4), generator=g), "b": torch.ones(4)},
        "opt": {"step": 7, "mu": {"w": torch.zeros((4, 4))}},
    }


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0)
            for k, v in tree.items()}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    path = save(str(tmp_path), 7, tree)
    template = _zeros_like(tree)
    ptrs = {k: v.data_ptr() for k, v in _leaves(template) if isinstance(v, torch.Tensor)}
    out = restore(path, template)
    assert out is template
    for (ka, a), (kb, b) in zip(_leaves(out), _leaves(tree)):
        assert ka == kb
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b) and a.data_ptr() == ptrs[ka]
        else:
            assert a == b and type(a) is type(b)


def test_manager_keep_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        m.save(s, _tree())
    assert m.steps() == [20, 30]
    assert m.latest_step() == 30


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    m.save_async(5, _tree())
    m.wait()
    assert m.latest_step() == 5
    (rec,) = m.saves
    assert rec["step"] == 5 and rec["write_s"] is not None
    assert rec["nbytes"] == sum(v.numel() * 4 for _, v in _leaves(_tree()) if isinstance(v, torch.Tensor)) + 8


def test_partial_checkpoint_ignored(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(10, _tree())
    os.makedirs(tmp_path / "step_00000020")  # a crash mid-write: no manifest
    assert m.latest_step() == 10


def test_shape_mismatch_raises(tmp_path):
    path = save(str(tmp_path), 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore(path, {"w": torch.zeros((3, 3))})


def test_missing_key_raises(tmp_path):
    path = save(str(tmp_path), 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(KeyError, match="missing"):
        restore(path, {"w": torch.zeros((2, 2)), "v": torch.zeros(1)})


def test_restore_latest_none_when_empty(tmp_path):
    m = CheckpointManager(str(tmp_path))
    step, tree = m.restore_latest({"x": torch.zeros(1)})
    assert step is None and tree is None


def test_layout_is_the_jax_packages(tmp_path):
    """Same directory names and manifest; the JAX manager lists the steps
    the port wrote and ignores what it would ignore."""
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (3, 8, 12):
        m.save(s, _tree())
    os.makedirs(tmp_path / ".tmp-step_00000013")
    assert sorted(os.listdir(tmp_path)) == [".tmp-step_00000013", "step_00000008", "step_00000012"]
    assert JaxManager(str(tmp_path)).steps() == m.steps() == [8, 12]
    manifest = json.loads((tmp_path / "step_00000012" / "manifest.json").read_text())
    assert manifest["complete"] and manifest["step"] == 12
    assert manifest["keys"] == ["opt/mu/w", "opt/step", "params/b", "params/w"]
    with np.load(tmp_path / "step_00000012" / "arrays.npz") as z:
        np.testing.assert_array_equal(z["params/w"], _tree()["params"]["w"].numpy())


def test_bf16_leaf_is_stored_as_raw_words(tmp_path):
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    path = save(str(tmp_path), 1, {"w": w})
    assert json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())["dtypes"]["w"] == "bfloat16"
    out = restore(path, {"w": torch.zeros((3, 5), dtype=torch.bfloat16)})
    assert torch.equal(out["w"], w)


def test_snapshot_is_complete_when_save_async_returns(tmp_path):
    """The step updates its tensors in place right after a save: the
    checkpoint holds the values at the call."""
    tree = _tree()
    want = tree["params"]["w"].clone()
    m = CheckpointManager(str(tmp_path))
    m.save_async(1, tree)
    tree["params"]["w"].add_(1.0)  # the next step's in-place update
    m.wait()
    out = m.restore_latest(_zeros_like(_tree()))[1]
    assert torch.equal(out["params"]["w"], want)
    assert [r["step"] for r in m.restores] == [1] and m.saves[0]["snapshot_s"] > 0


def test_train_state_roundtrip_keeps_parameter_storage(tmp_path):
    """A smoke Mixtral's train state after one ef8 step, restored into a
    fresh step's state: every leaf equal, every tensor in its own storage,
    and the model's parameters are those tensors."""
    jcfg = jax_smoke("mixtral-8x7b")
    pcfg = dataclasses.replace(smoke_config("mixtral-8x7b"), remat="none")
    params = jax.tree.map(np.array, JaxModel(jcfg).init(jax.random.PRNGKey(0)))

    def stepper():
        model = load_reference(pcfg, params, device="cpu", dtype=torch.float32, param_dtype=torch.float32,
                               requires_grad=True)
        return model, make_train_step(model, AdamW(lr=1e-3), grad_compress="ef8")

    model, step = stepper()
    tokens = np.random.default_rng(0).integers(0, pcfg.vocab_size, (2, 16))
    step({"tokens": tokens, "targets": np.roll(tokens, -1, 1)})
    CheckpointManager(str(tmp_path)).save(1, step.state)
    model2, step2 = stepper()
    ptrs = {n: p.data_ptr() for n, p in model2.named_parameters()}
    _, out = CheckpointManager(str(tmp_path)).restore_latest(step2.state)
    assert out["opt"]["step"] == 1
    for (ka, a), (kb, b) in zip(_leaves(out), _leaves(step.state)):
        assert ka == kb
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b, ka
    assert all(p.data_ptr() == ptrs[n] for n, p in model2.named_parameters())
    assert all(torch.equal(p, model.get_parameter(n)) for n, p in model2.named_parameters())
