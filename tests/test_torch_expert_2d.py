"""2D expert sharding (``MoECfg.expert_2d``) across a 4-rank gloo world laid
out as (data 2, model 2), held against one process and the JAX package.

Under 2D a rank holds E / n_model experts and its data group's F / n_data
slice of their FFN width (JAX's ``P(EP, None, "data")`` and ``P(EP,
"data", None)``); each expert block's tokens are all-gathered over the
data group around K1 on that slice and the partial outputs
reduce-scattered back.  One module-scoped world runs
``_torch_world.expert_2d_world`` (the ranks import ``repro_torch`` only);
this process computes the one-process and the JAX sides.

* (a) one MoE layer (``tests/multidev_fabric.py``'s smoke layer, d 32, 8
  experts of 48, top-2, capacity 8.0: nothing drops), each data group on
  its rows of the batch, on the dense EP form, ``a2a``, ``ppermute`` (a
  max-weight plan, and a plan whose pair recurs over two phases with
  offsets), ``phase_pipelined``, ``ragged_a2a``, ``hierarchical`` (pods of
  1 and of 2) and ``faulty:phase_pipelined`` (a link not yet dark):
  values within 1e-5 of JAX's dense layer and of one process's, gradients
  within 2e-4 (``tests/multidev_moe.py``'s 2D check); a link dark from the
  start refused; each rank's shapes E/n_model x F/n_data; one grouped
  GEMM a ``ppermute`` phase (as JAX under 2D);
* (b) the smoke Qwen3-MoE train step at capacity 8.0: step 0's reduced
  gradients, gathered to the one-process layout, within 1e-5 relative L2
  a leaf of one process's; the first 4 losses of ``train_loop`` within
  1e-4 of JAX's one-device ``train_loop``;
* (c) the clip norm equal to one process's;
* (d) a 2D (2, 2) checkpoint restored into one process and onto (1, 4)
  without 2D, and that (1, 4) state saved and restored into 2D (2, 2):
  parameters and both moments bit for bit;
* the transplant's 2D slices gathered back into JAX's pytree exactly;
* (e) the serve launcher refuses ``expert_2d`` across data groups.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.data import DataConfig as JaxData
from repro.models import Model as JaxModel
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import train_loop as jax_train_loop

import _torch_world as tw
from repro_torch.checkpoint import restore
from repro_torch.core import decompose, plan_schedule
from repro_torch.core.schedule import A2ASchedule, phase_offsets
from repro_torch.models import moe as pmoe
from repro_torch.optim import AdamW
from repro_torch.parallel.sharding import spawn_world
from repro_torch.train import make_train_step
from test_torch_fabric_world import _jax_layer, _params
from test_torch_train_world import BATCH, NODROP, SEQ, _cfg, _jax_cfg

N_DATA, N_MODEL = 2, 2
VAL_TOL, GRAD_TOL = 1e-5, 2e-4  # tests/multidev_moe.py's 2D bounds
STEP_GRAD_TOL, JAX_LOSS_TOL = 1e-5, 1e-4
LAYER_CASES = ("dense", "a2a", "ppermute", "ppermute_multi", "phase_pipelined", "ragged_a2a", "hierarchical",
               "hierarchical_pod2", "faulty_phase_pipelined")
PATHS = {"dense": "dense_ep", "ppermute_multi": "ppermute", "hierarchical_pod2": "hierarchical",
         "faulty_phase_pipelined": "faulty:phase_pipelined"}


class _AllExperts:
    def expert_range(self, e):
        return 0, e


def _traffic(cfg, params, x):
    """[n_model, n_model] choices from a model rank's sequence chunk to each
    model rank, the larger of the two data groups' (one plan serves both)."""
    p = tw.load_layer(cfg, params, _AllExperts())
    b, s, d = x.shape
    e_local = cfg.moe.n_experts // N_MODEL
    mat = np.zeros((N_DATA, N_MODEL, N_MODEL))
    for g in range(N_DATA):
        for i in range(N_MODEL):
            rows = x[g * b // N_DATA:(g + 1) * b // N_DATA, i * s // N_MODEL:(i + 1) * s // N_MODEL]
            idx, _ = pmoe._router(p, cfg, torch.from_numpy(rows.reshape(-1, d)))
            np.add.at(mat[g, i], idx.numpy().ravel() // e_local, 1)
    return mat.max(axis=0)


def _two_phase(plan):
    """``plan``'s one swap phase as two phases of the same pair, each with
    the full cap, the second shipping the bucket's next slice (offsets): a
    pair recurring over phases, which a BvN plan of 2 ranks never has."""
    perms, valid = np.repeat(plan.perms, 2, axis=0), np.repeat(plan.valid, 2, axis=0)
    caps = np.repeat(plan.caps, 2).astype(np.int32)
    return A2ASchedule(perms=perms, caps=caps, valid=valid, offsets=phase_offsets(perms, valid, caps).astype(np.int32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = tw.layer_cfg()
    params = _params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    traffic = _traffic(cfg, params, x)
    plan = plan_schedule(decompose(traffic, "maxweight"), slack=1.5, quantum=8)
    multi = _two_phase(plan)
    row = ("row", plan, "auto")
    jparams = jax.tree.map(np.array, JaxModel(_jax_cfg()).init(jax.random.PRNGKey(0)))
    spec = {
        "params": params, "x": x,
        "cases": {
            "dense": ("dense", None, {}), "a2a": ("a2a", None, {}), "ppermute": ("ppermute", plan, {}),
            "ppermute_multi": ("ppermute", multi, {}), "phase_pipelined": ("phase_pipelined", row, {}),
            "ragged_a2a": ("ragged_a2a", row, {}),
            "hierarchical": ("hierarchical", ("hrow", traffic, 1), {"pod_size": 1}),
            "hierarchical_pod2": ("hierarchical", ("hrow", traffic, 2), {"pod_size": 2}),
            "faulty_phase_pipelined": ("faulty:phase_pipelined", row, {"onset": 20}),
            "faulty_routed": ("faulty:phase_pipelined", row, {"onset": 0}),
        },
        "nodrop": tw.with_2d(_cfg(NODROP)), "data": dict(vocab_size=_cfg().vocab_size, seq_len=SEQ, global_batch=BATCH),
        "train_params": jparams, "ckpt": str(tmp_path_factory.mktemp("expert_2d")),
    }
    ranks = spawn_world(tw.expert_2d_world, N_DATA * N_MODEL, layout=(N_DATA, N_MODEL), args=(spec,), timeout_s=240)
    return {"spec": spec, "ranks": ranks, "cfg": cfg, "plan": plan, "multi": multi}


def _rows(g, b=4):
    return slice(g * b // N_DATA, (g + 1) * b // N_DATA)


def _f_slice(name: str, g: int, f: int):
    """Data group ``g``'s FFN slice of an expert leaf [E, d, F] / [E, F, d]."""
    part = slice(g * f // N_DATA, (g + 1) * f // N_DATA)
    return np.s_[:, part] if name.endswith("w_down") else np.s_[..., part]


@pytest.fixture(scope="module")
def references(world):
    """JAX's dense layer and one process's (the port's virtual fabric) on the whole batch."""
    jax_layers.COMPUTE_DTYPE, old = jnp.float32, jax_layers.COMPUTE_DTYPE
    try:
        jref = _jax_layer(world["cfg"], world["spec"]["params"], world["spec"]["x"])
    finally:
        jax_layers.COMPUTE_DTYPE = old
    p = tw.load_layer(world["cfg"], world["spec"]["params"], _AllExperts())
    one = tw.run_layer(p, world["cfg"], torch.from_numpy(world["spec"]["x"]), None, None)
    return {"jax": jref, "one": one}


def _assert_2d_layer(ranks, ref, case, f):
    e_local = 8 // N_MODEL
    for r, rank in enumerate(ranks):
        g, me = divmod(r, N_MODEL)
        np.testing.assert_allclose(rank["y"], ref["y"][_rows(g)], rtol=VAL_TOL, atol=VAL_TOL,
                                   err_msg=f"{case} rank {r} y")
        for name in ("w_gate", "w_up", "w_down"):
            want = ref[name][me * e_local:(me + 1) * e_local][_f_slice(name, g, f)]
            np.testing.assert_allclose(rank[name], want, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{case} rank {r} d{name}")
        np.testing.assert_array_equal(rank["routing"].sum(0), ref["routing"].sum(0))
        assert float(rank["dropped"].sum()) == 0.0
    np.testing.assert_allclose(sum(rank["router"] for rank in ranks), ref["router"], rtol=GRAD_TOL, atol=GRAD_TOL,
                               err_msg=f"{case} drouter summed over the world")
    for g in range(N_DATA):
        dx = sum(ranks[g * N_MODEL + j]["dx"] for j in range(N_MODEL))
        np.testing.assert_allclose(dx, ref["dx"][_rows(g)], rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{case} dx of data group {g}, summed over its model group")


@pytest.mark.parametrize("case", LAYER_CASES)
def test_2d_layer_matches_jax_and_one_process_dense(world, references, case):
    ranks = [r["cases"][case] for r in world["ranks"]]
    assert all("error" not in r for r in ranks), [r.get("message") for r in ranks]
    cfg = world["cfg"]
    f, e = cfg.moe.d_ff_expert, cfg.moe.n_experts
    for ref in (references["jax"], references["one"]):
        _assert_2d_layer(ranks, ref, case, f)
    d = cfg.d_model
    held = (e // N_MODEL, d, f // N_DATA), (e // N_MODEL, f // N_DATA, d)
    assert all(r["held"] == {"w_gate": held[0], "w_up": held[0], "w_down": held[1]} for r in ranks)
    path = PATHS.get(case, case)
    assert all(r["paths"] == {path: 1} for r in ranks), [r["paths"] for r in ranks]


def test_2d_ppermute_runs_a_gemm_a_phase(world):
    """Under 2D ``ppermute`` keeps one grouped GEMM a phase (and one for the
    local block), as JAX does, where the 1D path concatenates them into one
    (one K1 launch); ``a2a`` and the dense EP form run one as in 1D."""
    for r in world["ranks"]:
        for case, plan in (("ppermute", world["plan"]), ("ppermute_multi", world["multi"])):
            assert r["cases"][case]["gemms"] == plan.num_phases + 1, (case, r["cases"][case]["gemms"])
        assert r["cases"]["a2a"]["gemms"] == r["cases"]["dense"]["gemms"] == 1
    assert world["multi"].num_phases == 2 and world["multi"].offsets[1].max() > 0


def test_2d_faulty_refuses_a_dark_link_on_every_rank(world):
    for r in world["ranks"]:
        bad = r["cases"]["faulty_routed"]
        assert bad["error"] == "FabricFaultError" and "phase_pipelined" in bad["message"], bad


def _one_process_grads(world):
    spec = world["spec"]
    one = tw.step_grads(spec["nodrop"], spec["train_params"], None, spec["data"])
    assert one["dropped"] == 0.0
    return one


def _gathered(ranks, names_f, getter):
    """Rank values of ``key`` gathered to the one-process layout: an expert
    leaf over the data groups along its FFN axis, then over the model
    group along its experts; the rest from rank 0."""
    out = {}
    for name, v in getter(ranks[0]).items():
        if name not in names_f:
            out[name] = v
            continue
        axis = names_f[name]
        cols = [np.concatenate([getter(ranks[g * N_MODEL + j])[name] for g in range(N_DATA)], axis=axis)
                for j in range(N_MODEL)]
        out[name] = np.concatenate(cols, axis=0)
    return out


def _ffn_axes():
    """Each expert parameter's FFN-width axis (``Model.ffn_axes`` of a 2D model)."""
    return {f"layers.{l}.ffn.{n}": (1 if n == "w_down" else 2) for l in range(_cfg().n_layers)
            for n in ("w_gate", "w_up", "w_down")}


def test_2d_train_step_gradients_and_clip_norm_equal_one_process(world):
    one = _one_process_grads(world)
    ranks = [r["grads"] for r in world["ranks"]]
    axes = _ffn_axes()
    got = _gathered(ranks, axes, lambda r: r["grads"])
    assert sorted(got) == sorted(one["grads"])
    for name, g in got.items():
        want = one["grads"][name]
        rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= STEP_GRAD_TOL, (name, rel)
    for r in ranks:
        assert r["dropped"] == 0.0
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(r["norm"], one["norm"], rtol=STEP_GRAD_TOL)  # (c) the whole gradient's


def test_2d_losses_agree_with_jax_one_device(world, monkeypatch, tmp_path):
    spec = world["spec"]
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    jres = jax_train_loop(JaxModel(_jax_cfg(NODROP)), JaxData(**spec["data"]),
                          JaxLoopConfig(steps=4, ckpt_dir=str(tmp_path), ckpt_every=5, microbatches=2, peak_lr=1e-3,
                                        warmup=4, log_every=1))
    want = [h["loss"] for h in jres["history"]]
    assert len(want) == 4
    for r in world["ranks"]:
        assert r["loop"]["final_step"] == 4
        np.testing.assert_allclose([h["loss"] for h in r["loop"]["history"]], want, rtol=0, atol=JAX_LOSS_TOL)


def _states(rank_state):
    return {f"{part}/{name}": v for part, tree in rank_state.items() for name, v in tree.items()}


def test_2d_checkpoints_restore_across_layouts_bit_for_bit(world):
    ranks = world["ranks"]
    axes = {f"{part}/{name}": a for name, a in _ffn_axes().items() for part in ("params", "mu", "nu")}
    held = _gathered(ranks, axes, lambda r: _states(r["saved_2d"]))
    # the replicated leaves are the same on every rank
    for r in ranks[1:]:
        for key, v in _states(r["saved_2d"]).items():
            if key not in axes:
                np.testing.assert_array_equal(v, held[key], err_msg=key)
    # into one process
    model = tw.train_model(_cfg(NODROP), world["spec"]["train_params"], None)
    state = make_train_step(model, AdamW()).state
    restore(os.path.join(world["spec"]["ckpt"], "2d", "step_00000002"), state)
    assert state["opt"]["step"] == 2
    for key, v in _states({"params": state["params"], "mu": state["opt"]["mu"], "nu": state["opt"]["nu"]}).items():
        np.testing.assert_array_equal(v.detach().numpy(), held[key], err_msg=f"one process {key}")
    e_local = 8 // N_MODEL
    # onto (1, 4) without 2D: rank r holds experts [2r, 2r + 2), every FFN column
    for r, rank in enumerate(ranks):
        got = rank["restored_1d"]
        assert got["step"] == 2 and got["opt_step"] == 2 and got["me"] == r and got["ffn_axes"] == {}
        for key, v in _states(got["state"]).items():
            want = held[key][2 * r:2 * r + 2] if key in axes else held[key]
            np.testing.assert_array_equal(v, want, err_msg=f"(1, 4) rank {r} {key}")
    # that (1, 4) state saved and restored into 2D (2, 2)
    for r, rank in enumerate(ranks):
        g, me = divmod(r, N_MODEL)
        got = rank["restored_2d"]
        assert got["step"] == 7 and got["opt_step"] == 2
        for key, v in _states(got["state"]).items():
            want = held[key]
            if key in axes:
                want = want[me * e_local:(me + 1) * e_local][_f_slice(key, g, want.shape[axes[key]])]
            np.testing.assert_array_equal(v, want, err_msg=f"2D rank {r} {key}")


def test_2d_transplant_round_trips(world):
    """``load_reference(..., ffn_shard=)`` gives each rank JAX's leaf sliced
    by experts and FFN columns; ``to_reference(..., world=)`` gathers the
    slices back into JAX's pytree, on every rank, exactly."""
    want = jax.tree_util.tree_leaves_with_path(world["spec"]["train_params"])
    for r, rank in enumerate(world["ranks"]):
        got = dict(jax.tree_util.tree_leaves_with_path(rank["gathered"]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(got[path], leaf, err_msg=f"rank {r} {jax.tree_util.keystr(path)}")


def test_2d_serving_is_refused_across_data_groups(world):
    for r in world["ranks"]:
        assert r["serve"] is not None and "ROADMAP.md" in r["serve"] and "expert_2d" in r["serve"], r["serve"]
