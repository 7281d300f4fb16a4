"""The port's launchers' options against the JAX launchers' on the CPU.

``--wire-dtype`` on the training launcher: the first losses of
``repro_torch.launch.train --smoke --wire-dtype fp8 --device cpu`` equal
those of ``repro.launch.train`` with the same option, within 1e-4 (f32 on
both sides, the same rounding points, sums in another order; the
tolerance of the other launcher tests).  JAX's launcher runs its own
``main`` with two things taken out: the ``axis_rules`` context and the
batch sharding, whose one-device mesh this jax version refuses inside
``jit`` (nothing is sharded on one device either way).  Both sides start
from ``Model.init(PRNGKey(0))`` (the port's model transplanted from it)
and compute in f32.  With ``--dispatch phase_pipelined`` JAX plans over
the port's 8 virtual ranks at batch x seq / 8 tokens a rank, as the
port's launcher does (JAX's own ``n`` is its mesh's model axis, which
depends on this process's devices; the mesh is used for nothing else), so
the fp8 codec quantizes the slots that cross ranks on both sides.

``--dispatch hierarchical --pod-size``: the same, each launcher planning
its two-level table (``build_hierarchical_table``) over the virtual ranks;
the tables equal JAX's leaf for leaf.

``--drift``: the serving launcher's default is JAX's, and ``main``
hands it to the controller unless ``--drift none`` is passed.

Under ``torchrun`` the training launcher trains across the ranks: a
4-rank gloo run of ``--smoke --device cpu`` starts from one process's
step-0 loss, and its next loss stays within ``TORCHRUN_BF16_TOL`` of it.
"""

import argparse
import contextlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.dryrun as jax_dryrun
import repro.launch.serve as jax_serve
import repro.launch.train as jax_train
import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.models import Model as JaxModel

import repro_torch.launch.serve as serve_mod
import repro_torch.launch.train as train_mod
from repro_torch.models.transplant import load_reference
from repro_torch.parallel.fabric.base import Fabric

VIRTUAL_RANKS = 8
# the launcher computes in bf16: across ranks the dense fabric's EP form sums a token's expert outputs in another
# order, and Adam's first update (m / sqrt(v) = sign(g) elementwise) turns those roundings into whole steps
# where a gradient is near zero; measured 4.1e-3 at step 1 (in f32 the world equals one process within 1e-6,
# tests/test_torch_train_world.py)
TORCHRUN_BF16_TOL = 1e-2
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)


def _jax_launcher(monkeypatch, argv, tokens):
    """Run ``repro.launch.train.main(argv)``, its plan made over ``VIRTUAL_RANKS`` ranks of ``tokens //
    VIRTUAL_RANKS`` tokens (whatever mesh this process's devices give); returns (the model's config, the
    loop's result)."""
    seen = {}
    loop = jax_train.train_loop

    def run(model, data_cfg, loop_cfg, shard_batch=None):
        seen["cfg"] = model.cfg
        seen["res"] = loop(model, data_cfg, loop_cfg)
        return seen["res"]

    monkeypatch.setattr(jax_train, "train_loop", run)
    monkeypatch.setattr(jax_train, "axis_rules", lambda mesh, rules: contextlib.nullcontext())
    build = jax_dryrun.build_schedule
    monkeypatch.setattr(jax_dryrun, "build_schedule", lambda cfg, n, t_rank, **kw: build(
        cfg, VIRTUAL_RANKS, tokens // VIRTUAL_RANKS, **kw))
    jax_train.main(argv)
    return seen["cfg"], seen["res"]


def _port_launcher(monkeypatch, argv):
    """Run ``repro_torch.launch.train.main(argv)`` on the JAX initial parameters; returns (the model's
    config, the result, the wire-crossing slots each ``wire_encode`` saw, by codec)."""
    seen, wire = {}, []

    def model(cfg, **kw):
        seen["cfg"] = cfg
        params = JaxModel(jax_smoke(cfg.name.removesuffix("-smoke"))).init(jax.random.PRNGKey(0))
        return load_reference(cfg, jax.tree.map(np.array, params), device=kw["device"], dtype=torch.float32,
                              param_dtype=torch.float32, requires_grad=True)

    encode = Fabric.wire_encode

    def spy(self, ctx, packed):
        wire.append((ctx.moe.wire_dtype, 0 if packed.wire is None else int(packed.wire.sum())))
        return encode(self, ctx, packed)

    monkeypatch.setattr(train_mod, "Model", model)
    monkeypatch.setattr(Fabric, "wire_encode", spy)
    res = train_mod.main([*argv, "--device", "cpu", "--virtual-ranks", str(VIRTUAL_RANKS)])
    return seen["cfg"], res, wire


@pytest.mark.parametrize("dispatch", [None, "phase_pipelined"])
def test_train_launcher_wire_dtype_losses_equal_jax(tmp_path, monkeypatch, f32, dispatch):
    argv = ["--smoke", "--wire-dtype", "fp8", "--steps", "3", "--seq", "32", "--batch", "4"]
    if dispatch:
        argv += ["--dispatch", dispatch]
    jcfg, jres = _jax_launcher(monkeypatch, [*argv, "--ckpt", str(tmp_path / "jax")], tokens=4 * 32)
    pcfg, pres, wire = _port_launcher(monkeypatch, [*argv, "--ckpt", str(tmp_path / "port")])
    assert jcfg.moe.wire_dtype == pcfg.moe.wire_dtype == "fp8"
    assert jcfg.moe.dispatch == pcfg.moe.dispatch == (dispatch or "dense")
    assert [h["step"] for h in pres["history"]] == [h["step"] for h in jres["history"]] == [0, 2]
    np.testing.assert_allclose([h["loss"] for h in pres["history"]], [h["loss"] for h in jres["history"]],
                               rtol=0, atol=1e-4)
    assert pres["final_step"] == jres["final_step"] == 3 and pres["failures"] == jres["failures"] == 0
    assert wire and {w for w, _ in wire} == {"fp8"}
    # the codec acts only where a table row marks slots that cross the virtual ranks
    assert (sum(n for _, n in wire) > 0) == (dispatch is not None)


@pytest.mark.parametrize("pod_size", [2, 4])
def test_train_launcher_pod_size_losses_equal_jax(tmp_path, monkeypatch, f32, pod_size):
    """``--dispatch hierarchical --pod-size``: both launchers plan a two-level table of the same expected
    traffic over the virtual ranks (JAX's ``build_hierarchical_table``, the port's), and the first losses
    agree."""
    argv = ["--smoke", "--dispatch", "hierarchical", "--pod-size", str(pod_size), "--steps", "3", "--seq", "32",
            "--batch", "4"]
    tokens, hbuild, tables = 4 * 32, jax_dryrun.build_hierarchical_table, {}

    def jax_table(cfg, n, t_rank, n_layers, **kw):
        tables["jax"] = hbuild(cfg, VIRTUAL_RANKS, tokens // VIRTUAL_RANKS, n_layers, **kw)
        return tables["jax"]

    monkeypatch.setattr(jax_dryrun, "build_hierarchical_table", jax_table)
    jcfg, jres = _jax_launcher(monkeypatch, [*argv, "--ckpt", str(tmp_path / "jax")], tokens=tokens)
    pcfg, pres, _ = _port_launcher(monkeypatch, [*argv, "--ckpt", str(tmp_path / "port")])
    assert jcfg.moe.pod_size == pcfg.moe.pod_size == pod_size
    assert jcfg.moe.dispatch == pcfg.moe.dispatch == "hierarchical"
    ptab, jtab = pres["table"], tables["jax"]
    assert ptab.pod_size == jtab.pod_size == pod_size
    for level in ("intra", "inter"):
        for name in ("perms", "caps", "valid", "offsets", "n_phases"):
            np.testing.assert_array_equal(getattr(getattr(ptab, level), name).numpy(),
                                          np.asarray(getattr(getattr(jtab, level), name)), err_msg=f"{level} {name}")
    np.testing.assert_allclose([h["loss"] for h in pres["history"]], [h["loss"] for h in jres["history"]],
                               rtol=0, atol=1e-4)
    assert pres["final_step"] == jres["final_step"] == 3 and pres["failures"] == jres["failures"] == 0


@pytest.mark.parametrize("plan", ["literal", "lossless", "v2"])
def test_build_hierarchical_table_equals_jax(plan):
    from repro.configs import get_config as jax_get_config

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import build_hierarchical_table

    got = build_hierarchical_table(get_config("mixtral-8x7b"), 8, 512, 4, plan=plan)
    want = jax_dryrun.build_hierarchical_table(jax_get_config("mixtral-8x7b"), 8, 512, 4, plan=plan)
    assert got.pod_size == want.pod_size == 2 and got.num_layers == 4
    for level in ("intra", "inter"):
        for name in ("perms", "caps", "valid", "offsets", "n_phases"):
            np.testing.assert_array_equal(getattr(getattr(got, level), name).numpy(),
                                          np.asarray(getattr(getattr(want, level), name)), err_msg=f"{level} {name}")
        assert getattr(got, level).envelope == tuple(getattr(want, level).envelope)
    for fn, cfg in ((build_hierarchical_table, get_config("mixtral-8x7b")),
                    (jax_dryrun.build_hierarchical_table, jax_get_config("mixtral-8x7b"))):
        with pytest.raises(ValueError, match="no 'bvn' plan preset"):
            fn(cfg, 8, 512, 4, plan="bvn")


def test_train_launcher_wire_dtype_choices_are_jax():
    from repro.parallel.fabric import codec_names as jax_codec_names

    from repro_torch.parallel.fabric import codec_names

    assert codec_names() == tuple(jax_codec_names())
    with pytest.raises(SystemExit):
        train_mod.main(["--smoke", "--wire-dtype", "fp4", "--device", "cpu"])


class _Parsed(Exception):
    pass


def _parsed_args(monkeypatch, main, argv):
    """The namespace ``main(argv)`` parses, stopping it there."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        main(argv)
    return got.value.args[0]


def test_serve_parser_defaults_drift_as_jax(monkeypatch):
    port = _parsed_args(monkeypatch, serve_mod.main, ["--smoke", "--controller"])
    ref = _parsed_args(monkeypatch, jax_serve.main, ["--smoke", "--controller"])
    assert port.drift == ref.drift == "shift"


@pytest.mark.parametrize("argv,drift", [([], "shift"), (["--drift", "none"], "none")])
def test_serve_launcher_drifts_unless_told_none(monkeypatch, argv, drift):
    seen = []
    make = serve_mod.make_serving_controller

    def spy(cfg, **kw):
        seen.append(kw["drift"])
        return make(cfg, **kw)

    monkeypatch.setattr(serve_mod, "make_serving_controller", spy)
    res = serve_mod.main(["--smoke", "--controller", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "1", "--rounds", "2", *argv])
    assert seen == [drift] and res.tokens.shape == (2, 2, 1)


def test_torchrun_trains_a_world_on_the_cpu(tmp_path):
    """The documented command, ``torchrun --nproc-per-node 4 -m
    repro_torch.launch.train --smoke --device cpu``, at a small size: 4
    ranks laid out as (data 1, model 4) (``train_mesh_shape``), rank 0
    logs; its step-0 loss is one process's at the same global batch, to
    the 4 decimals logged, and its step-1 loss within TORCHRUN_BF16_TOL."""
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32", "--batch", "4"]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4", "-m",
           "repro_torch.launch.train", *argv, "--ckpt", str(tmp_path / "world")]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stderr.count("world of 4 ranks as (data 1, model 4)") == 1, res.stderr[-3000:]  # rank 0 logs
    world = {int(m[1]): float(m[2]) for m in re.finditer(r"^step (\d+) loss ([\d.]+) ", res.stderr, re.M)}
    one = train_mod.main([*argv, "--ckpt", str(tmp_path / "one")])
    want = {h["step"]: h["loss"] for h in one["history"]}
    assert sorted(world) == sorted(want) == [0, 1]
    assert world[0] == round(want[0], 4)
    assert abs(world[1] - want[1]) <= TORCHRUN_BF16_TOL, (world, want)


def test_train_launcher_world_needs_a_card_unless_cpu(monkeypatch):
    """Under torchrun on the card (the default) a rank without one raises
    before it joins a process group, so no other rank waits for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--smoke", "--steps", "1"])
    assert not torch.distributed.is_initialized()
