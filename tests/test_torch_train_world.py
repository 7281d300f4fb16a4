"""Training across the ranks of a world on the CPU: JAX's
``tests/multidev_train.py`` checks on the port, and the port's gradients,
losses and checkpoints against one process and the JAX package.

One module-scoped world of 4 spawned ranks laid out as (data 2, model 2)
runs ``_torch_world.train_world`` (the ranks import ``repro_torch`` only);
this process computes the one-process and the JAX sides.  The model is
``multidev_train.py``'s: the smoke Qwen3-MoE-235B-A22B (8 experts, top-2)
under ``a2a`` dispatch, sequences of 16, a global batch of 8 in 2
microbatches, AdamW at peak 1e-3 after 4 warmup steps, checkpoints every
5 steps, on JAX's ``Model.init(PRNGKey(0))`` transplanted in f32.

* (a) a clean 12-step run whose loss falls; the same run with a failure
  injected on rank 1 only, at step 8 (first attempt), which every rank
  rolls back, ending at the clean run's final loss within ``LOSS_RTOL``
  (JAX's bound); the fault run's checkpoint restored onto (data 1, model
  4) for 3 more steps;
* (b) the host controller over ``scheduled`` dispatch under ``shift``
  drift at step 6 (``ema=1.0, cooldown=2, group_by="model"``): it
  re-plans and swaps, every rank's table equal after every swap, and
  ``table_rebuilds == envelope_growths <= 1`` where JAX holds
  ``compiles``;
* (c) at capacity factor ``NODROP`` (an expert's bucket holds twice the
  tokens a rank routes, so nothing drops: checked), step 0's gradients
  as the update sees them (partial shares summed over the model group,
  averaged over the data groups) equal to the one-process port's on the
  same weights and the global batch, leaf for leaf within ``GRAD_TOL``
  relative L2, and the clip norm the whole gradient's, under ``a2a`` (the
  outputs all-gathered over the model group) and under the dense fabric's
  EP form (an all-reduce combine, whose backward feeds a residual branch);
* (d) the first 4 losses of that run against ``repro.train.train_loop`` on
  one JAX device (``COMPUTE_DTYPE`` f32), within ``JAX_LOSS_TOL``;
* (e) the (2, 2) checkpoint of step 12 restored into one process, leaf for
  leaf equal to the state the ranks held, gathered (the two data groups'
  replicas equal too);
* (f) ef8, the fused device-controller step, a fabric switch and
  ``expert_2d`` refused under the world with ``NotImplementedError``.

The 8-rank runs exactly as JAX runs them, (4, 2) then (2, 4), are the
``slow`` test at the end.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs import smoke_config as jax_smoke
from repro.data import DataConfig as JaxData
from repro.models import Model as JaxModel
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import train_loop as jax_train_loop

import _torch_world as tw
from repro_torch.checkpoint import restore
from repro_torch.configs import smoke_config
from repro_torch.optim import AdamW
from repro_torch.parallel.data_parallel import batch_rows
from repro_torch.models import Model
from repro_torch.models import stack
from repro_torch.parallel.sharding import World, current_world, ep_world, mesh_shape, spawn_world, train_mesh_shape
from repro_torch.train import make_train_step

ARCH = "qwen3-moe-235b-a22b"
SEQ, BATCH = 16, 8
# capacity factor where nothing drops: top-2 of 8 experts, so a bucket of 8 * 2 / 8 * t = 2t slots holds every
# token a rank routes (each token picks an expert once)
NODROP = 8.0
FAULT_RANK = 1
LOSS_RTOL = 1e-5  # multidev_train.py's bound on the fault run's final loss
GRAD_TOL = 1e-5  # relative L2 per leaf: the same f32 products, summed over ranks in another order
JAX_LOSS_TOL = 1e-4  # the port's loop tests' bound (f32, the same rounding points, sums in another order)
WORLD_TIMEOUT_S = 150


def _cfg(capacity=None):
    cfg = smoke_config(ARCH)
    moe = dataclasses.replace(cfg.moe, dispatch="a2a")
    if capacity is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity)
    return dataclasses.replace(cfg, moe=moe)


def _jax_cfg(capacity=None):
    cfg = jax_smoke(ARCH)
    moe = dataclasses.replace(cfg.moe, dispatch="a2a")
    if capacity is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity)
    return dataclasses.replace(cfg, moe=moe)


def _spec(tmp, layout_b, nodrop=True):
    cfg = _cfg()
    params = jax.tree.map(np.array, JaxModel(_jax_cfg()).init(jax.random.PRNGKey(0)))
    return {"cfg": cfg, "params": params, "data": dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH),
            "ckpt": str(tmp), "fault_rank": FAULT_RANK, "layout_b": layout_b,
            "nodrop": _cfg(NODROP) if nodrop else None}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    spec = _spec(tmp_path_factory.mktemp("train_world"), (1, 4))
    ranks = spawn_world(tw.train_world, 4, layout=(2, 2), args=(spec,), timeout_s=WORLD_TIMEOUT_S)
    return spec, ranks


def _losses(res):
    return [h["loss"] for h in res["history"]]


def _check_multidev(ranks, steps_b):
    """multidev_train.py's clean, fault and elastic assertions on every rank."""
    clean0 = ranks[0]["clean"]
    for r, rank in enumerate(ranks):
        clean, fault, el = rank["clean"], rank["fault"], rank["elastic"]
        losses = _losses(clean)
        assert clean["final_step"] == 12 and np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert _losses(clean) == _losses(clean0)  # the global batch's loss, on every rank alike
        assert fault["fired"] == (r == FAULT_RANK)
        assert fault["failures"] == 1 and fault["final_step"] == 12
        assert [h["step"] for h in fault["history"]] == list(range(12))
        np.testing.assert_allclose(fault["final_loss"], clean["final_loss"], rtol=LOSS_RTOL)
        assert el["final_step"] == steps_b and np.isfinite(el["final_loss"])
        assert [h["step"] for h in el["history"]] == list(range(12, steps_b))


def test_clean_fault_and_elastic_runs_as_multidev_train(world):
    _, ranks = world
    _check_multidev(ranks, 15)
    # the elastic run's layout: (data 1, model 4)
    assert [(r["elastic"]["data_index"], r["elastic"]["me"]) for r in ranks] == [(0, 0), (0, 1), (0, 2), (0, 3)]


def test_fault_on_one_rank_replays_the_clean_steps(world):
    """Every replayed step gives the clean run's loss: the rollback is world-wide."""
    _, ranks = world
    for rank in ranks:
        np.testing.assert_allclose(_losses(rank["fault"]), _losses(rank["clean"]), rtol=LOSS_RTOL)


def _check_controller(ranks):
    ctl0 = ranks[0]["controller"]
    for rank in ranks:
        res = rank["controller"]
        ctl = res["metrics"]
        assert res["final_step"] == 12 and np.isfinite(res["final_loss"])
        assert ctl["replan_events"] >= 1 and ctl["decompose_calls"] == ctl["replan_events"]
        assert ctl["swaps"] >= 1
        # no compiles in the port: table storage rebuilt only by an accounted envelope growth
        assert ctl["table_rebuilds"] == ctl["envelope_growths"] <= 1, ctl
        assert _decisions(ctl) == _decisions(ctl0["metrics"])
        assert len(res["tables"]) == ctl["swaps"]
        for got, want in zip(res["tables"], ctl0["tables"]):
            for name in want:
                np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]), err_msg=name)


def _decisions(metrics):
    """The controller's counters and state, without its host timings."""
    return {k: v for k, v in metrics.items() if not k.endswith(("_us_per_step", "_ms_per_event"))}


def test_controller_swaps_the_same_tables_on_every_rank(world):
    _, ranks = world
    _check_controller(ranks)


@pytest.mark.parametrize("dispatch", ["a2a", "dense"])
def test_world_gradients_equal_one_process(world, dispatch):
    spec, ranks = world
    one = tw.step_grads(tw.with_dispatch(spec["nodrop"], dispatch), spec["params"], None, spec["data"])
    assert one["dropped"] == 0.0
    n_model = 2
    for r, rank in enumerate(ranks):
        got = rank["grads"][dispatch]
        assert got["dropped"] == 0.0
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["norm"], one["norm"], rtol=GRAD_TOL)
        assert sorted(got["grads"]) == sorted(one["grads"])
        for name, g in got["grads"].items():
            want = one["grads"][name]
            if g.shape != want.shape:  # an expert leaf: this rank's slice
                e = g.shape[0]
                me = r % n_model
                want = want[me * e:(me + 1) * e]
            rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
            assert rel <= GRAD_TOL, (r, name, rel)


def test_losses_agree_with_jax_one_device(world, monkeypatch, tmp_path):
    spec, ranks = world
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jres = jax_train_loop(JaxModel(_jax_cfg(NODROP)), JaxData(**spec["data"]),
                          JaxLoopConfig(steps=4, ckpt_dir=str(tmp_path), ckpt_every=5, microbatches=2, peak_lr=1e-3,
                                        warmup=4, log_every=1))
    want = _losses(jres)
    assert len(want) == 4
    for rank in ranks:
        np.testing.assert_allclose(_losses(rank["nodrop_loop"]), want, rtol=0, atol=JAX_LOSS_TOL)


def test_world_checkpoint_restores_into_one_process(world):
    spec, ranks = world
    # the state the ranks held at step 12 (the fault run's last checkpoint), gathered: the replicated leaves
    # from rank 0, the experts over data group 0's model group; data group 1 holds the same replicas
    n_model = 2
    model = tw.train_model(spec["cfg"], spec["params"], None)
    experts = model.expert_names()
    held = {}
    for name, v in ranks[0]["fault"]["state"].items():
        parts = [ranks[j]["fault"]["state"][name] for j in range(n_model)]
        held[name] = np.concatenate(parts) if name in experts else v
        for j in range(n_model):
            np.testing.assert_array_equal(ranks[n_model + j]["fault"]["state"][name], parts[j], err_msg=name)
    state = make_train_step(model, AdamW()).state
    restore(os.path.join(spec["ckpt"], "fault", "step_00000012"), state)
    assert state["opt"]["step"] == 12
    for name, p in state["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(), held[name], err_msg=name)


def test_world_refuses_what_it_does_not_run(world):
    _, ranks = world
    for rank in ranks:
        for case, msg in rank["refused"].items():
            assert msg is not None and "ROADMAP.md" in msg, (case, msg)


@pytest.mark.parametrize("n,want", [(1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (1, 4)), (6, (3, 2)), (8, (1, 8)),
                                    (12, (3, 4)), (24, (3, 8)), (32, (2, 16)), (48, (3, 16))])
def test_train_mesh_shape_is_jax_build_mesh(n, want):
    """JAX's ``build_mesh``: the model axis is the largest of 16, 8, 4, 2, 1 that divides n."""
    model = next(c for c in (16, 8, 4, 2, 1) if n % c == 0 and c <= n)
    assert train_mesh_shape(n) == (n // model, model) == want


def test_layouts_and_batch_rows():
    class W:  # a rank's place: data group 1 of 2
        n_data, data_index = 2, 1

    assert mesh_shape(8) == (2, 4) and train_mesh_shape(8) == (1, 8)
    assert batch_rows(8, W) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split over 2 data groups"):
        batch_rows(7, W)
    with pytest.raises(ValueError, match="does not lay out 4 ranks"):
        spawn_world(tw.train_world, 4, layout=(3, 2))


def test_remat_recomputes_under_the_forward_world(monkeypatch):
    """The card's autograd runs the backward on a thread of its own, where
    the caller's ``ep_world`` is not current: a block's recompute (remat
    per block) must see the world its forward saw."""
    cfg = dataclasses.replace(smoke_config("mixtral-8x7b"), n_layers=1, remat="block")
    model = Model(cfg, device="cpu", dtype=torch.float32, param_dtype=torch.float32, requires_grad=True, seed=0)
    one = World(rank=0, size=1, n_data=1, n_model=1, backend="gloo", device=torch.device("cpu"), model_group=None,
                data_group=None)
    seen, block_train = [], stack.block_train

    def spy(*args, **kw):
        seen.append(current_world())
        return block_train(*args, **kw)

    monkeypatch.setattr(stack, "block_train", spy)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(0))
    with ep_world(one):
        loss = model.loss({"tokens": tokens, "targets": tokens})
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    assert seen == [one, one]  # the forward, then its recompute on the other thread
    assert model.embed.grad is not None


@pytest.mark.slow
def test_eight_ranks_as_jax_runs_them(tmp_path):
    """multidev_train.py's layouts: (data 4, model 2), the elastic restart
    onto (data 2, model 4), the controller at (4, 2)."""
    spec = _spec(tmp_path, (2, 4), nodrop=False)
    ranks = spawn_world(tw.train_world, 8, layout=(4, 2), args=(spec,), timeout_s=4 * WORLD_TIMEOUT_S)
    _check_multidev(ranks, 15)
    _check_controller(ranks)
