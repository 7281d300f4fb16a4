"""The fault-tolerant training loop on the card, at smoke width: the fused
device-controller step with ef8 and the chunked attention (1 x 2048
tokens), K1, K2 and K3 launched by every step, one injected fault rolled
back to its checkpoint, and a second call that resumes.  Skips without a
CUDA device; imports no JAX.  Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_loop_cuda.py

Checks (as ``chip_smoke.py``'s train-loop phase at full width): one
failure, unique sorted history steps, the final steps, the checkpoint
steps on disk, the resumed parameters equal to the checkpoint's arrays
bit for bit, replayed steps equal to the first pass where the table was
the same, finite losses, K1/K2/K3 launched 2/1/1 times a layer for every
executed step, and ef8 on the card equal to the CPU bit for bit.

Across ranks (as ``chip_smoke.py``'s phase 15 at full width): a 2-rank
world sharing the card over gloo, laid out as (data 1, model 2), trains
the smoke Mixtral under ``phase_pipelined``; a failure on rank 1 alone
rolls both ranks back, ending at the clean run's final loss within 1e-5,
and the checkpoint restored onto (data 2, model 1) trains on; K1/K2/K3
launched 2/1/1 times an expert block of each layer call.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import _torch_world as tw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig
from repro_torch.kernels.moe_gemm import ops as k1
from repro_torch.launch.train import plan_controller
from repro_torch.models import Model
from repro_torch.optim import ef_int8_compress, ef_int8_init
from repro_torch.parallel.sharding import spawn_world
from repro_torch.train import TrainLoopConfig, train_loop

SEQ, FAULT_AT, STEPS, RESUME_STEPS = 2048, 7, 10, 12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


class _Losses(logging.Handler):
    """(step, loss) of every history entry the loop logs, replays included."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen = []

    def emit(self, record):
        if record.msg.startswith("step %d loss"):
            self.seen.append(record.args[:2])


@pytest.mark.cuda
def test_train_loop_survives_a_fault_and_resumes_on_card(cuda_device, tmp_path):
    cfg = smoke_config("mixtral-8x7b")
    # remat per block, so each step's backward recomputes the forward: K1 twice a step, as phase 8b runs it
    cfg = dataclasses.replace(cfg, n_layers=1, remat="block",
                              moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined"))
    model = Model(cfg, device=cuda_device, param_dtype=torch.float32, requires_grad=True, seed=0)
    # a 10-step cooldown keeps steps 5-6 and their replay under one table (chip_smoke.py, LOOP_COOLDOWN)
    _, ctrl, state = plan_controller(cfg, batch=1, seq=SEQ, virtual_ranks=8, device=cuda_device, cooldown=10)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=1)
    plans, fired = {}, []

    def hook(step):
        plans.setdefault(step, []).append(tuple(getattr(state, n).cpu().numpy().tobytes()
                                                for n in ("perms", "caps", "valid", "n_phases")))
        if step == FAULT_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    losses = _Losses()
    logging.getLogger("repro_torch.train").addHandler(losses)
    logging.getLogger("repro_torch.train").setLevel(logging.INFO)
    for fn in (k1.moe_gemm, k1.moe_gemm_dgrad, k1.moe_gemm_wgrad):
        fn.launches = 0
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=5, keep=1, peak_lr=3e-4, warmup=2, log_every=1,
              grad_compress="ef8")
    try:
        res = train_loop(model, data, TrainLoopConfig(steps=STEPS, **kw), failure_hook=hook,
                         device_controller=ctrl, device_ctrl_state=state)
        assert CheckpointManager(str(tmp_path)).steps() == [STEPS]
        with np.load(tmp_path / f"step_{STEPS:08d}" / "arrays.npz") as z:
            saved = {n: z[f"params/{n}"] for n in ("embed", "layers.0.ffn.w_gate", "ln_f")}
        resumed = {}

        def check_resume(step):
            if not resumed:
                resumed.update(step=step, **{n: model.get_parameter(n).detach().cpu().numpy().copy() for n in saved})

        res2 = train_loop(model, data, TrainLoopConfig(steps=RESUME_STEPS, **kw), failure_hook=check_resume,
                          device_controller=ctrl, device_ctrl_state=state)
    finally:
        logging.getLogger("repro_torch.train").removeHandler(losses)
    assert res["failures"] == 1 and res["final_step"] == STEPS and res2["final_step"] == RESUME_STEPS
    steps = [h["step"] for h in res["history"]]
    assert steps == sorted(set(steps)) == list(range(STEPS))
    assert [h["step"] for h in res2["history"]] == [STEPS, STEPS + 1] and resumed["step"] == STEPS
    assert CheckpointManager(str(tmp_path)).steps() == [RESUME_STEPS]
    for n, arr in saved.items():
        np.testing.assert_array_equal(resumed[n], arr, err_msg=n)
    assert all(np.isfinite(l) for _, l in losses.seen)
    first = dict(losses.seen[:FAULT_AT])
    replay = dict(losses.seen[FAULT_AT:FAULT_AT + 2])
    assert sorted(replay) == [5, 6]
    same = True
    for s in (5, 6):
        same &= plans[s][0] == plans[s][1]  # this step and the replayed ones before it under the same tables
        if same:
            assert replay[s] == first[s], (s, replay[s], first[s])
    executed = FAULT_AT + (STEPS - 5) + (RESUME_STEPS - STEPS)
    assert (k1.moe_gemm.launches, k1.moe_gemm_dgrad.launches, k1.moe_gemm_wgrad.launches) == (
        2 * executed, executed, executed)


@pytest.mark.cuda
def test_ef8_on_card_equals_cpu(cuda_device):
    """Three compression steps of the same gradients on both devices:
    the same bits (every operation is correctly rounded on both)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 64, 192), "b": (8, 64, 192), "c": (1000,)}
    groups = [["a", "b"], ["c"]]
    on = {dev: ef_int8_init({n: torch.zeros(s, device=dev) for n, s in shapes.items()}) for dev in ("cpu", cuda_device)}
    for _ in range(3):
        g = {n: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 1, s)).astype(np.float32) for n, s in shapes.items()}
        out = {}
        for dev, ef in on.items():
            # a copy of its own for each device: ef_int8_compress writes the dequantized gradient in place,
            # and torch.from_numpy(v).to("cpu") would share (and so overwrite) the next device's input
            grads = {n: torch.tensor(v, device=dev) for n, v in g.items()}
            ef_int8_compress(grads, ef, groups)
            out[dev] = grads
        for n in shapes:
            assert torch.equal(out["cpu"][n], out[cuda_device][n].cpu()), n
            assert torch.equal(on["cpu"][n], on[cuda_device][n].cpu()), n


@pytest.mark.cuda
def test_train_world_survives_a_fault_on_one_rank_and_restarts_on_card(cuda_device, tmp_path):
    from repro_torch.kernels import build

    build.build_all()  # once, before the ranks start, so they do not race nvcc
    cfg = smoke_config("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, remat="block", moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined"))
    steps, fault_at, ckpt_every, more = 6, 4, 3, 2
    spec = {"cfg": cfg, "data": dict(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4), "steps": steps,
            "ckpt": str(tmp_path), "ckpt_every": ckpt_every, "fault_rank": 1, "fault_at": fault_at,
            "layout_b": (2, 1), "more_steps": more}
    ranks = spawn_world(tw.card_train_world, 2, device="cuda", layout=(1, 2), args=(spec,), timeout_s=300)
    executed = {"clean": steps, "fault": steps + fault_at - ckpt_every, "elastic": more}
    for r, rank in enumerate(ranks):
        clean, fault, el = rank["clean"], rank["fault"], rank["elastic"]
        losses = [h["loss"] for h in clean["history"]]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert fault["fired"] == (r == 1) and fault["failures"] == 1 and fault["final_step"] == steps
        np.testing.assert_allclose(fault["final_loss"], clean["final_loss"], rtol=1e-5)
        assert el["final_step"] == steps + more and np.isfinite(el["final_loss"])
        for name, n in executed.items():
            blocks = rank[name]["per_call"] * cfg.n_moe_layers * n
            assert rank[name]["launches"] == {"k1": 2 * blocks, "k2": blocks, "k3": blocks}, (r, name)
