"""The EP fabrics across 4 ranks sharing the card (gloo, CUDA tensors),
at small shapes: K1 forward and K2/K3 backward on every fabric.  Skips
without a CUDA device; imports no JAX.  Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fabric_world_cuda.py

Each rank computes one process's dense fabric on the whole layer with the
same kernels (the reference) and each fabric across the 4 ranks, in bf16:
the output within K1's tolerance (2e-2 + 2e-2 |ref|); each expert's
gradients, and the router's and the input's partial gradients summed
over the ranks, within 2e-2 relative L2 (``chip_smoke.py``'s
``GRAD_REL_TOL``: a fabric sums an expert's bf16 gradient over several
launches, or the input's over several ranks, where the reference rounds
one sum, so an elementwise bound fails where the parts cancel);
``routing`` summed over the ranks equal to the reference's, nothing
dropped, ``ragged_a2a`` equal to ``phase_pipelined`` bit for bit, and
K1/K2/K3 launched exactly once a grouped GEMM (phase_pipelined: once a
live phase plus the local block).
"""

import numpy as np
import pytest
import torch

import _torch_world as tw
from repro_torch.core import decompose, plan_schedule
from repro_torch.parallel.sharding import spawn_world

TOL, GRAD_REL_TOL = 2e-2, 2e-2
CASES = ("dense", "a2a", "ppermute", "phase_pipelined", "ragged_a2a")


@pytest.fixture(scope="module")
def card_ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    from repro_torch.kernels import build

    build.build_all()  # once, before the ranks start, so they do not race nvcc
    cfg = tw.ModelConfig(name="fabric-card", family="moe", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
                         vocab_size=97, moe=tw.MoECfg(n_experts=8, top_k=2, d_ff_expert=128, capacity_factor=8.0))
    rng = np.random.default_rng(0)
    d, f, e = 64, 128, 8
    params = {"router": (rng.standard_normal((d, e)) * 0.5).astype(np.float32),
              "w_gate": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
              "w_up": (rng.standard_normal((e, d, f)) * d**-0.5).astype(np.float32),
              "w_down": (rng.standard_normal((e, f, d)) * f**-0.5).astype(np.float32)}
    x = rng.standard_normal((4, 64, d)).astype(np.float32)
    traffic = np.full((4, 4), 4 * 64 * 2 / 16.0)
    plan = plan_schedule(decompose(traffic, "maxweight"), slack=2.0)
    spec = {"cfg": cfg, "params": params, "x": x,
            "cases": {"dense": ("dense", None), "a2a": ("a2a", None), "ppermute": ("ppermute", plan),
                      "phase_pipelined": ("phase_pipelined", ("row", plan, "auto")),
                      "ragged_a2a": ("ragged_a2a", ("row", plan, "auto"))}}
    torch.cuda.empty_cache()
    return spawn_world(tw.card_world, tw.N_RANKS, device="cuda", args=(spec,), timeout_s=300), plan


def _close(got, want, what):
    excess = np.abs(got - want) - TOL * np.abs(want)
    assert excess.max() <= TOL, f"{what}: max excess {excess.max():.3g}"


def _rel_l2(got, want, what):
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= GRAD_REL_TOL, f"{what}: relative L2 {rel:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_fabric_on_card_matches_the_dense_layer(card_ranks, case):
    ranks, _ = card_ranks
    ref = ranks[0]["ref"]
    for r, rank in enumerate(ranks):
        got = rank[case]
        _close(got["y"], ref["y"], f"{case} rank {r} y")
        for name in ("w_gate", "w_up", "w_down"):
            _rel_l2(got[name], rank["ref"][name], f"{case} rank {r} d{name}")
        assert float(got["dropped"].sum()) == 0.0
        np.testing.assert_array_equal(got["routing"].sum(0), ref["routing"].sum(0))
    for name in ("router", "dx"):
        _rel_l2(sum(rank[case][name] for rank in ranks), ref[name], f"{case} d{name} summed over ranks")


@pytest.mark.cuda
def test_ragged_equals_phase_pipelined_on_card(card_ranks):
    ranks, _ = card_ranks
    for rank in ranks:
        for key in ("y", "dx", "router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(rank["ragged_a2a"][key], rank["phase_pipelined"][key], err_msg=key)


@pytest.mark.cuda
def test_kernel_launches_on_card(card_ranks):
    ranks, plan = card_ranks
    live = sum(1 for v in tw.build_table(plan, "auto").envelope_slots(2) if v)
    for rank in ranks:
        for case in CASES:
            k1 = live + 1 if case in ("phase_pipelined", "ragged_a2a") else 1
            assert rank[case]["launches"] == {"k1": k1, "k2": k1, "k3": k1}, (case, rank[case]["launches"])
