"""The port's fault-tolerant training loop (``repro_torch.train.loop``)
against ``repro.train.train_loop`` on the CPU.

Both sides start from ``Model.init(PRNGKey(0))``, transplanted into the
port in f32 (``COMPUTE_DTYPE`` patched to f32 on the JAX side), and read
the same ``SyntheticStream`` batches.  The JAX loop's fresh state after a
rollback without a checkpoint is ``Model.init(PRNGKey(0))`` again; the
port's is the parameters at loop entry: the same values.

Which MoE path JAX runs: the smoke Mixtral loops of up to 8 steps
(``test_loop_equals_jax``, ``test_resume_equals_jax``) run
``use_pallas=True`` (the grouped kernel in interpret mode); every other
run (the failure budget, the host runtime, the device controller, the
link flap; 10-30 steps) runs the JAX MoE's plain path, on the small MoE
config of the JAX package's own loop tests (``_moe_cfg``: d 32, 4/2
heads, 8 experts top-2).

Held exactly: history steps, failure counts, attempts, swaps, re-plans,
decisions, tables, controller counters and fabric switches.  Losses
within 1e-4 (observed within 1e-5: f32, the same rounding points, sums
in another order).  Parameters after a rollback within 1e-4 absolute
(observed below 2e-6 after 10 AdamW steps at lr 1e-3).  Device-controller
leaves: integer and bool exactly, f32 within 1e-6 relative.  Where JAX's
tests hold ``compiles == 0`` the port holds ``table_rebuilds == 0``.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.models.layers as jax_layers
from repro.checkpoint import CheckpointManager as JaxManager
from repro.configs import smoke_config as jax_smoke
from repro.configs.base import ModelConfig as JaxConfig
from repro.configs.base import MoECfg as JaxMoE
from repro.core import ScheduleTable as JaxTable
from repro.data import DataConfig as JaxData
from repro.launch.dryrun import build_schedule as jax_build_schedule
from repro.models import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import train_loop as jax_train_loop

import repro_torch.core as pc
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.data import DataConfig
from repro_torch.launch.train import plan_table
from repro_torch.models.transplant import load_reference, to_reference
from repro_torch.train import TrainLoopConfig, train_loop

N_V, E = 4, 8


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)


def _small_cfgs(dispatch="dense", n_layers=2):
    """The JAX loop tests' config (``tests/test_schedule_table.py`` ``_moe_cfg``) in both packages."""
    kw = dict(name="loop-test", family="moe", n_layers=n_layers, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
              vocab_size=128, remat="none")
    moe = dict(n_experts=E, top_k=2, d_ff_expert=32, dispatch=dispatch)
    return JaxConfig(**kw, moe=JaxMoE(**moe)), ModelConfig(**kw, moe=MoECfg(**moe))


def _models(jcfg, pcfg, jschedule=None):
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    port = load_reference(pcfg, jax.tree.map(np.array, params), device="cpu", dtype=torch.float32,
                          param_dtype=torch.float32, requires_grad=True)
    return JaxModel(jcfg, jschedule), port


def _loops(tmp_path, jcfg, pcfg, *, seq=16, batch=4, jschedule=None, jkw=None, pkw=None, **cfg):
    """Run both loops with the same config; returns (jax result, port result, port model)."""
    jmodel, pmodel = _models(jcfg, pcfg, jschedule)
    (tmp_path / "jax").mkdir(exist_ok=True)
    (tmp_path / "port").mkdir(exist_ok=True)
    jres = jax_train_loop(jmodel, JaxData(vocab_size=jcfg.vocab_size, seq_len=seq, global_batch=batch),
                          JaxLoopConfig(ckpt_dir=str(tmp_path / "jax"), **cfg), **(jkw or {}))
    pres = train_loop(pmodel, DataConfig(vocab_size=pcfg.vocab_size, seq_len=seq, global_batch=batch),
                      TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **cfg), **(pkw or {}))
    return jres, pres, pmodel


def _same_history(jres, pres, tol=1e-4):
    assert [h["step"] for h in pres["history"]] == [h["step"] for h in jres["history"]]
    np.testing.assert_allclose([h["loss"] for h in pres["history"]], [h["loss"] for h in jres["history"]],
                               rtol=0, atol=tol)
    assert pres["final_step"] == jres["final_step"] and pres["failures"] == jres["failures"]


def _once(step_at):
    fired = []

    def boom(step):
        if step == step_at and not fired:
            fired.append(step)
            raise RuntimeError("injected fault")

    return boom


# ------------------------------------------------------------ the plain loop
def _mixtral(tmp_path, steps, grad_compress=None, **kw):
    """Smoke Mixtral under the launcher's lossless phase_pipelined table
    (JAX holds it as the model's static schedule, the port takes
    ``schedule=``), the JAX grouped kernel in interpret mode."""
    jcfg = jax_smoke("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, remat="none", moe=dataclasses.replace(jcfg.moe, dispatch="phase_pipelined",
                                                                           use_pallas=True))
    pcfg = smoke_config("mixtral-8x7b")
    pcfg = dataclasses.replace(pcfg, remat="none", moe=dataclasses.replace(pcfg.moe, dispatch="phase_pipelined"))
    b, s = 4, 32
    jtable = JaxTable.from_schedules([jax_build_schedule(jcfg, 8, b * s // 8, plan="lossless")] * jcfg.n_layers,
                                     envelope="auto")
    ptable = plan_table(pcfg, batch=b, seq=s, virtual_ranks=8, device="cpu")
    return _loops(tmp_path, jcfg, pcfg, seq=s, batch=b, jschedule=jtable, pkw=dict(schedule=ptable, **kw.pop("pkw", {})),
                  jkw=kw.pop("jkw", None), steps=steps, ckpt_every=4, keep=3, peak_lr=1e-3, warmup=2, log_every=1,
                  grad_compress=grad_compress, **kw)


@pytest.mark.parametrize("grad_compress", [None, "ef8"])
def test_loop_equals_jax(tmp_path, grad_compress):
    jres, pres, _ = _mixtral(tmp_path, 5, grad_compress)
    _same_history(jres, pres)
    assert pres["failures"] == 0 and pres["final_step"] == 5
    assert sorted(pres) == sorted(jres)


def test_resume_equals_jax(tmp_path):
    """A second call on the same directory resumes from its latest
    checkpoint (the first call's last step, 6), on both sides, and logs
    from there."""
    _mixtral(tmp_path, 6, "ef8")
    jres, pres, _ = _mixtral(tmp_path, 8, "ef8")
    assert [h["step"] for h in pres["history"]] == [6, 7]
    _same_history(jres, pres)


# ---------------------------------------------------------- failure budget
def test_rollback_dedupes_history_and_equals_jax(tmp_path):
    """A failure past a checkpoint replays steps: the same unique, sorted
    history steps, one failure, and parameters within 1e-4 of JAX's."""
    jcfg, pcfg = _small_cfgs()
    jres, pres, pmodel = _loops(
        tmp_path, jcfg, pcfg, jkw=dict(failure_hook=_once(6)), pkw=dict(failure_hook=_once(6)),
        steps=10, ckpt_every=4, keep=3, peak_lr=1e-3, warmup=2, log_every=1, max_failures=3,
    )
    steps = [h["step"] for h in pres["history"]]
    assert steps == sorted(set(steps)) == list(range(10)) and pres["failures"] == 1
    _same_history(jres, pres)
    # the JAX loop's final state is its last checkpoint (step 10)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    template = {"params": params, "opt": JaxAdamW().init(params), "ef": {}}
    jparams = JaxManager(str(tmp_path / "jax")).restore_latest(template)[1]["params"]
    got = jax.tree_util.tree_flatten_with_path(to_reference(pmodel))[0]
    for (path, a), b in zip(got, jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4, err_msg=jax.tree_util.keystr(path))


def test_transient_faults_spread_across_run_survive(tmp_path):
    """More faults than max_failures in total, each retry passing: both
    loops finish, count 4 failures and log the same steps."""

    def spread():
        fired = set()

        def boom(step):
            if step in (3, 5, 7, 9) and step not in fired:
                fired.add(step)
                raise RuntimeError(f"transient fault @ {step}")

        return boom

    jcfg, pcfg = _small_cfgs()
    jres, pres, _ = _loops(tmp_path, jcfg, pcfg, jkw=dict(failure_hook=spread()), pkw=dict(failure_hook=spread()),
                           steps=12, ckpt_every=4, keep=3, peak_lr=1e-3, warmup=2, log_every=1, max_failures=2)
    assert pres["failures"] == 4 and pres["final_step"] == 12
    _same_history(jres, pres)


def _attempts(fail_at):
    seen = []

    def hook(step):
        seen.append(step)
        if fail_at is not None and step == fail_at:
            raise RuntimeError("persistent fault")

    return hook, seen


@pytest.mark.parametrize("case", ["persistent", "nan"])
def test_budget_exhausts_after_the_same_attempts(tmp_path, case):
    """A step that keeps failing (``persistent``), or a loss that turns
    non-finite at ``peak_lr=1e6`` (``nan``: ``NonFiniteLossError``), raises
    after ``max_failures`` consecutive retries, with the same steps
    attempted as JAX's loop."""
    jcfg, pcfg = _small_cfgs()
    fail_at = 5 if case == "persistent" else None
    (jhook, jseen), (phook, pseen) = _attempts(fail_at), _attempts(fail_at)
    err = RuntimeError if case == "persistent" else pc.NonFiniteLossError
    match = "persistent fault" if case == "persistent" else "non-finite loss"
    cfg = dict(steps=10, ckpt_every=4, keep=3, peak_lr=1e-3 if case == "persistent" else 1e6, warmup=2,
               log_every=1, max_failures=2)
    jmodel, pmodel = _models(jcfg, pcfg)
    with pytest.raises(jc.NonFiniteLossError if case == "nan" else RuntimeError, match=match):
        jax_train_loop(jmodel, JaxData(vocab_size=128, seq_len=16, global_batch=4),
                       JaxLoopConfig(ckpt_dir=str(tmp_path / "jax"), **cfg), failure_hook=jhook)
    with pytest.raises(err, match=match):
        train_loop(pmodel, DataConfig(vocab_size=128, seq_len=16, global_batch=4),
                   TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **cfg), failure_hook=phook)
    assert pseen == jseen
    if case == "persistent":
        assert pseen.count(5) == 3  # the budget + the final fatal attempt


# ------------------------------------------------------------ host runtime
def _drift_hook(shift_at, reverse):
    base = np.linspace(1.0, 2.0, E)
    base /= base.sum()
    after = base[::-1] ** 4 if reverse else base**6
    after = after / after.sum()

    def hook(step, stats):
        probs = base if step < shift_at else after
        totals = stats.sum(axis=(1, 2), keepdims=True)
        return np.broadcast_to(probs[None, None, :], stats.shape) * totals

    return hook


@pytest.mark.parametrize("envelope_slack", [0.0, 1.5])
def test_runtime_drift_swaps_equal_jax(tmp_path, envelope_slack):
    """Drift injected through ``stats_hook`` (``tests/test_schedule_table.py``
    ``test_drift_swap_zero_compiles_in_train_loop``): the same swaps,
    decisions, counters and final table; ``table_rebuilds`` where JAX
    counts ``compiles`` (0, or the envelope's growths)."""
    jcfg, pcfg = _small_cfgs("scheduled")
    rts = []
    for mod in (jc, pc):
        rt = mod.ScheduleRuntime(mod.ControllerConfig(n_ranks=N_V, n_experts=E, ema=1.0, cooldown=2,
                                                      envelope_slack=envelope_slack), 2)
        rt.prime(np.full((N_V, N_V), 8 * 32 * 2 / N_V**2))
        rts.append(rt)
    jres, pres, _ = _loops(
        tmp_path, jcfg, pcfg, seq=32, batch=8,
        jkw=dict(runtime=rts[0], stats_hook=_drift_hook(6, True)), pkw=dict(runtime=rts[1], stats_hook=_drift_hook(6, True)),
        steps=14, ckpt_every=20, peak_lr=1e-3, warmup=4, log_every=5,
    )
    _same_history(jres, pres)
    jctl, pctl = jres["controller"], pres["controller"]
    for key in ("swaps", "replan_events", "decompose_calls", "warm_hits", "cold_plans", "switches", "phase_clips",
                "envelope_growths", "envelope_shrinks", "envelope", "library_sizes", "steps", "fabric_switches",
                "final_dispatch", "health_state"):
        assert pctl[key] == jctl[key], key
    assert pctl["swaps"] >= 1
    assert pctl["table_rebuilds"] == jctl["compiles"]
    if envelope_slack:
        assert pctl["table_rebuilds"] == pctl["envelope_growths"] <= 1
    else:
        assert pctl["table_rebuilds"] == 0 == pctl["envelope_growths"]
    for key in ("warm_hits", "cold", "layers"):
        assert rts[1].last_event[key] == rts[0].last_event[key], key
    pt, jt = rts[1].table(), rts[0].table()
    for name in ("perms", "caps", "valid", "offsets", "n_phases"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(jt, name)), err_msg=name)


# ---------------------------------------------------------- device controller
def test_device_controller_rides_the_fused_step(tmp_path):
    """``tests/test_lap_jax.py`` ``test_device_controller_rides_the_fused_step``:
    10 fused steps; the same steps and re-plans, the telemetry on every
    history entry, and the final controller leaves equal."""
    jcfg, pcfg = _small_cfgs("scheduled")
    ctrls = []
    for mod in (jc, pc):
        rt = mod.ScheduleRuntime(mod.ControllerConfig(n_ranks=N_V, n_experts=E, ema=1.0, cooldown=2), 2)
        rt.prime(np.full((N_V, N_V), 8 * 32 * 2 / N_V**2))
        ctrls.append(mod.DeviceController.from_runtime(rt, hysteresis_steps=1))
    (jctrl, jstate), (pctrl, pstate) = ctrls
    jres, pres, _ = _loops(
        tmp_path, jcfg, pcfg, seq=32, batch=8,
        jkw=dict(device_controller=jctrl, device_ctrl_state=jstate),
        pkw=dict(device_controller=pctrl, device_ctrl_state=pstate),
        steps=10, ckpt_every=20, peak_lr=1e-3, warmup=4, log_every=5,
    )
    _same_history(jres, pres)
    pctl, jctl = pres["controller"], jres["controller"]
    assert pctl["mode"] == "device" and pctl["table_rebuilds"] == 0 and jctl["compiles"] == 0
    assert pctl["steps"] == jctl["steps"] == 10 + 1
    for key in ("device_replans", "drift_streak", "cooldown_left", "drop_spikes", "link_masked", "final_dispatch"):
        assert pctl[key] == jctl[key], key
    assert [h["device_replans"] for h in pres["history"]] == [h["device_replans"] for h in jres["history"]]
    np.testing.assert_allclose([h["drop_fraction"] for h in pres["history"]],
                               [h["drop_fraction"] for h in jres["history"]], rtol=1e-6, atol=0)
    jfinal = jres["device_ctrl_state"]
    for name, leaf in pres["device_ctrl_state"].leaves().items():
        want = np.asarray(getattr(jfinal, name))
        if want.dtype.kind == "f":
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=name)


# ----------------------------------------------------------------- link flap
def test_link_flap_training_recovers_as_jax(tmp_path):
    """``tests/test_faults.py`` ``test_link_flap_training_recovers``: a seeded
    link flap mid-train raises ``FabricFaultError``, the runtime
    quarantines ``phase_pipelined`` and the loop falls back to ``dense``,
    then probes back.  The same failures, fabric switches, quarantines,
    masked re-plans and final dispatch as JAX's loop."""
    jcfg, pcfg = _small_cfgs("phase_pipelined")
    kw = dict(steps=30, ckpt_every=4, peak_lr=5e-3, warmup=5, log_every=2)
    runs = {}
    for mod, name in ((jc, "jax"), (pc, "port")):
        rt = mod.ScheduleRuntime(mod.ControllerConfig(
            n_ranks=N_V, n_experts=E, ema=1.0, cooldown=2, envelope_slack=2.0,
            fallback_chain=("phase_pipelined", "dense"), quarantine_after=2, probe_backoff=4, recover_after=2,
        ), 2)
        rt.prime(np.full((N_V, N_V), 50.0))
        sc = mod.FaultScenario("link_flap", n_ranks=N_V, onset=8, window=6, n_links=2, seed=3)
        rt.attach_faults(sc)
        runs[name] = dict(runtime=rt, failure_hook=mod.fault_hook(sc, rt, backend="phase_pipelined"))
    jres, pres, pmodel = _loops(tmp_path, jcfg, pcfg, seq=32, batch=8, jkw=runs["jax"], pkw=runs["port"], **kw)
    _same_history(jres, pres)
    jctl, pctl = jres["controller"], pres["controller"]
    assert pres["failures"] >= 1 and pctl["fabric_switches"] >= 2
    for key in ("fabric_faults", "quarantines", "masked_replans", "fabric_switches", "final_dispatch",
                "fallback_active", "health_state", "probe_failures", "swaps", "replan_events"):
        assert pctl[key] == jctl[key], key
    assert pctl["final_dispatch"] == "phase_pipelined" == pmodel.cfg.moe.dispatch
    assert pctl["table_rebuilds"] <= pctl["envelope_growths"] + pctl["envelope_shrinks"]


# --------------------------------------------------------- validation errors
def _raises(tmp_path, match, cfg=None, **kw):
    jcfg, pcfg = _small_cfgs(**(cfg or {}))
    _, pmodel = _models(jcfg, pcfg)
    with pytest.raises(ValueError, match=match):
        train_loop(pmodel, DataConfig(vocab_size=128, seq_len=16, global_batch=4),
                   TrainLoopConfig(steps=2, ckpt_dir=str(tmp_path)), **kw)


def _rt(n_layers=2, **kw):
    return pc.ScheduleRuntime(pc.ControllerConfig(n_ranks=N_V, n_experts=E, **kw), n_layers)


def _primed(**kw):
    rt = _rt(**kw)
    rt.prime(np.full((N_V, N_V), 10.0))
    return rt


@pytest.mark.parametrize("case", [
    "mutually_exclusive", "stats_hook", "initial_state", "unprimed", "baked", "device_fabric", "no_schedule",
    "chain_start", "chain_baked", "unknown_dispatch",
])
def test_validation_errors(tmp_path, case):
    ctrl, state = pc.DeviceController.from_runtime(_primed())
    if case == "mutually_exclusive":
        _raises(tmp_path, "mutually exclusive", {"dispatch": "scheduled"}, runtime=_primed(),
                device_controller=ctrl, device_ctrl_state=state)
    elif case == "stats_hook":
        _raises(tmp_path, "stats_hook", {"dispatch": "scheduled"}, stats_hook=lambda s, x: x,
                device_controller=ctrl, device_ctrl_state=state)
    elif case == "initial_state":
        _raises(tmp_path, "initial state", {"dispatch": "scheduled"}, device_controller=ctrl)
    elif case == "unprimed":
        _raises(tmp_path, "prime", {"dispatch": "scheduled"}, runtime=_rt())
    elif case == "baked":
        _raises(tmp_path, "bakes its schedule", {"dispatch": "ppermute"}, runtime=_primed())
    elif case == "device_fabric":
        _raises(tmp_path, "table-consuming", {"dispatch": "dense"}, device_controller=ctrl, device_ctrl_state=state)
    elif case == "no_schedule":
        _raises(tmp_path, "needs a schedule", {"dispatch": "phase_pipelined"})
    elif case == "chain_start":
        _raises(tmp_path, "must start at", {"dispatch": "phase_pipelined"},
                runtime=_primed(fallback_chain=("ragged_a2a", "dense")))
    elif case == "chain_baked":
        _raises(tmp_path, "bakes its schedule", {"dispatch": "phase_pipelined"},
                runtime=_primed(fallback_chain=("phase_pipelined", "ppermute")))
    else:
        _raises(tmp_path, "unknown dispatch", {"dispatch": "carrier_pigeon"})


def test_loop_logs_each_history_entry(tmp_path, caplog):
    """The loop's log carries every history entry's exact loss (what the
    card run reads to compare replayed steps)."""
    jcfg, pcfg = _small_cfgs()
    _, pmodel = _models(jcfg, pcfg)
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        res = train_loop(pmodel, DataConfig(vocab_size=128, seq_len=16, global_batch=4),
                         TrainLoopConfig(steps=3, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=1))
    logged = [r.args[:2] for r in caplog.records if r.msg.startswith("step %d loss")]
    assert logged == [(h["step"], h["loss"]) for h in res["history"]]
