"""The fp8/int8 wire codecs on the virtual fabric: the port's
``parallel/fabric/codec.py`` and the MoE layer's wire legs against
``repro.parallel.fabric.codec`` and ``repro.models.moe`` on identical
inputs.

The reference's model steps run under ``jax.jit``, where XLA folds the
division of a slot's amax by 127 or 448 into a product with the f32
reciprocal fused with the 1e-12 add; the port rounds as that does, so
the codec is held against the jitted reference bit for bit (values
around every e4m3 rounding midpoint, exact int8 halves, and the ties
of that fused multiply-add included).

``moe_apply`` under fp8/int8: the dispatch leg (pack + wire encode) is
bit for bit on the same inputs; the output is held within one codec step
of the combine leg at the largest expert output (a slot's step is at
most amax / 14 in e4m3, amax / 127 in int8) plus the layer's own
tolerance (f32: 1e-5, the expert GEMMs summing in another order; bf16:
2e-2 + 2e-2·|ref|, as ``tests/test_torch_moe.py``): the expert outputs
differ from the reference's at the ulp, which can move a value on a
rounding boundary of the combine leg's codec by one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as jax_layers
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import MoECfg as JaxMoECfg
from repro.core import ScheduleTable as JaxTable
from repro.core import decompose as jax_decompose
from repro.core import plan_schedule as jax_plan
from repro.models import moe as jax_moe
from repro.parallel.fabric import codec as jcodec
from repro.parallel.fabric.base import FabricContext as JaxContext
from repro.parallel.fabric.base import get_fabric as jax_get_fabric

from repro_torch.configs import ModelConfig, MoECfg
from repro_torch.core import WIRE_DTYPES, ScheduleTable, decompose, plan_schedule
from repro_torch.models import moe as pmoe
from repro_torch.parallel.fabric import CODECS, DenseFabric, FabricContext, codec_names, get_codec

N_V = 8
ROW_FABRICS = ("phase_pipelined", "ragged_a2a")


def _moe_kw(dispatch, **kw):
    out = dict(n_experts=8, top_k=2, d_ff_expert=32, dispatch=dispatch, capacity_factor=8.0)
    out.update(kw)
    return out


def _jcfg(dispatch="dense", **kw):
    return JaxModelConfig(name="fabric-test", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                          vocab_size=128, moe=JaxMoECfg(**_moe_kw(dispatch, **kw)), remat="none")


def _pcfg(dispatch="dense", **kw):
    return ModelConfig(name="fabric-test", family="moe", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab_size=128, moe=MoECfg(**_moe_kw(dispatch, **kw)), remat="none")


def _traffic(seed):
    rng = np.random.default_rng(seed)
    m = rng.random((N_V, N_V)) * 400.0
    np.fill_diagonal(m, 0)
    return m


def _rows(seed):
    """The same plan as (port row, JAX row)."""
    m = _traffic(seed)
    port = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight"))], k_max=N_V, envelope="auto")
    ref = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight"))], k_max=N_V, envelope="auto")
    return port.row(0), ref.row(0)


def _params(dtype):
    params = jax.tree.map(np.asarray, jax_moe.moe_init(jax.random.PRNGKey(0), _jcfg()))
    p = pmoe.moe_init(_pcfg(), gen=None, device="cpu", dtype=dtype)
    p.router.data.copy_(torch.from_numpy(np.array(params["router"]["w"])))
    for name in ("w_gate", "w_up", "w_down"):
        getattr(p, name).data.copy_(torch.from_numpy(np.array(params[name])).to(dtype))
    return params, p


def _x():
    return np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 32, 32), jnp.float32))


def _bits(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


def _jit_qdq(name, x):
    return np.asarray(jax.jit(jcodec.get_codec(name).qdq)(jnp.asarray(x)))


def _jit_scale(name, x):
    return np.asarray(jax.jit(lambda v: jcodec.get_codec(name).encode(v)[1])(jnp.asarray(x)))


# ------------------------------------------------------- codec properties
class TestWireCodecProperties:
    """``tests/test_fabric.py``'s codec properties, on the port."""

    def test_registry_matches_pricing(self):
        assert set(CODECS) == set(WIRE_DTYPES) == set(jcodec.CODECS)
        assert codec_names() == tuple(sorted(CODECS)) == jcodec.codec_names()
        with pytest.raises(ValueError, match="bf16.*fp8.*int8"):
            get_codec("fp4")

    def test_bf16_is_identity_passthrough(self):
        codec = get_codec("bf16")
        assert codec.is_identity
        buf = torch.ones((3, 4, 8), dtype=torch.bfloat16)
        assert codec.apply(buf, torch.ones((3, 4), dtype=torch.bool)) is buf

    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_maskless_buffer_is_untouched(self, wire):
        buf = torch.ones((2, 8))
        assert get_codec(wire).apply(buf, None) is buf

    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_zero_slots_round_trip_exactly(self, wire):
        codec = get_codec(wire)
        x = torch.zeros((3, 5, 32))
        _, scale = codec.encode(x)
        assert torch.isfinite(scale).all()
        assert (codec.qdq(x) == 0.0).all()

    def test_int8_error_bounded_by_half_step(self):
        rng = np.random.default_rng(0)
        x = torch.from_numpy((rng.normal(size=(6, 32)) * (10.0 ** rng.integers(-4, 4, (6, 1)))).astype(np.float32))
        amax = x.abs().amax(-1, keepdim=True)
        assert ((get_codec("int8").qdq(x) - x).abs() <= amax / 127.0 * 0.5 + 1e-6).all()

    def test_fp8_error_bounded_by_e4m3_resolution(self):
        rng = np.random.default_rng(1)
        x = torch.from_numpy((rng.normal(size=(6, 32)) * 3.0).astype(np.float32))
        codec = get_codec("fp8")
        _, scale = codec.encode(x)
        assert ((codec.qdq(x) - x).abs() <= 0.0625 * x.abs() + scale).all()

    @pytest.mark.parametrize("wire", ["bf16", "fp8", "int8"])
    def test_max_step_over_amax_is_the_largest_gap_of_the_decoded_grid(self, wire):
        codec = get_codec(wire)
        if codec.is_identity:
            assert codec.max_step_over_amax == 0.0
            return
        # a slot with amax 1 and values densely between 0 and 1: the decoded grid's largest gap is the step
        x = torch.linspace(0.0, 1.0, 200001, dtype=torch.float32)[None, :]
        grid = torch.unique(codec.qdq(x))
        gap = float((grid[1:] - grid[:-1]).max())
        # the gaps are differences of f32 values near 1: an ulp of 1 apart at most from the exact step
        assert abs(gap - codec.max_step_over_amax) <= torch.finfo(torch.float32).eps, gap

    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_inf_adjacent_magnitudes_stay_finite(self, wire):
        x = torch.tensor([[3e38, -3e38, 1e-30, 0.0, -1.5, 2.5e37, -7e36, 1.0]])
        y = get_codec(wire).qdq(x)
        assert torch.isfinite(y).all()
        big = x.abs() >= 1e37
        assert (torch.sign(y[big]) == torch.sign(x[big])).all()
        assert abs(float(y[0, 0]) - 3e38) <= 0.0625 * 3e38

    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_single_token_slots(self, wire):
        x = torch.tensor([[3.7], [-0.003], [1e5], [0.0]])
        y = get_codec(wire).qdq(x)
        assert ((y - x).abs() <= 0.01 * x.abs() + 1e-9).all()

    @pytest.mark.parametrize("wire", ["fp8", "int8"])
    def test_ste_gradient_is_identity(self, wire):
        buf = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)).requires_grad_()
        mask = torch.tensor([True, False, True, True])
        (get_codec(wire).apply(buf, mask) * 3.0).sum().backward()
        assert (buf.grad == 3.0).all()


# ------------------------------------------------------ codec vs the reference
def _e4m3_sweep() -> np.ndarray:
    """Slots whose amax is 448 (scale 1 + eps, which rounds to 1): every
    finite e4m3 magnitude, the midpoints between neighbours and the f32
    values on either side of each midpoint, both signs."""
    vals = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn).float().numpy()
    vals = np.unique(np.abs(vals[np.isfinite(vals)]))
    mids = (vals[1:] + vals[:-1]) / 2
    grid = np.concatenate([vals, mids, np.nextafter(mids, np.float32(0)), np.nextafter(mids, np.float32(1e9))])
    grid = np.concatenate([grid, -grid]).astype(np.float32)
    grid = np.concatenate([grid, np.zeros((-grid.size) % 255, np.float32)]).reshape(-1, 255)
    return np.concatenate([np.full((grid.shape[0], 1), 448.0, np.float32), grid], axis=1)


def _fma_ties(name: str) -> np.ndarray:
    """Slots whose amax * f32(1/max) lands exactly on an f32 rounding tie
    (where rounding the fused multiply-add in two steps goes wrong)."""
    inv = np.float32(1) / np.float32(127.0 if name == "int8" else 448.0)
    frac, exp = np.frexp(np.float64(inv))
    m_inv = int(frac * 2**24)
    m = np.arange(2**23, 2**24, dtype=np.int64)
    prod = m * m_inv
    shift = np.floor(np.log2(prod.astype(np.float64))).astype(np.int64) + 1 - 24
    ties = m[(prod & ((np.int64(1) << shift) - 1)) == (np.int64(1) << (shift - 1))]
    amax = np.concatenate([(ties.astype(np.float64) * 2.0**e) for e in (20, 0, -30)]).astype(np.float32)
    x = np.zeros((amax.size, 4), np.float32)
    x[:, 0], x[:, 1], x[:, 2] = amax, -amax / 3, amax / 7
    return x


@pytest.mark.parametrize("name", ["fp8", "int8"])
def test_codec_equals_jitted_reference_bit_for_bit(name):
    rng = np.random.default_rng(0)
    cases = [
        (rng.normal(size=(64, 256)) * 10.0 ** rng.integers(-6, 6, (64, 1))).astype(np.float32),
        (10.0 ** rng.uniform(-10, -4, (4096, 1)) * rng.normal(size=(4096, 3))).astype(np.float32),  # eps-sized scales
        _fma_ties(name),
    ]
    if name == "fp8":
        cases += [_e4m3_sweep() * np.float32(s) for s in (1.0, 3.0, 1e-3, 7.77e5)]
    else:
        halves = np.concatenate([[127.0], np.arange(-127, 127) + 0.5, [0.0]]).astype(np.float32)[None, :]
        cases += [halves * np.float32(s) for s in (1.0, 0.37, 1e-5)]
    assert _fma_ties(name).shape[0] > 0
    for x in cases:
        q, scale = get_codec(name).encode(torch.from_numpy(x))
        np.testing.assert_array_equal(scale.numpy(), _jit_scale(name, x))
        np.testing.assert_array_equal(_bits(get_codec(name).qdq(torch.from_numpy(x)).numpy()), _bits(_jit_qdq(name, x)))
        assert q.dtype == (torch.int8 if name == "int8" else torch.float8_e4m3fn)


@pytest.mark.parametrize("name", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_and_its_ste_gradient_equal_the_jitted_reference(name, dtype):
    rng = np.random.default_rng(3)
    buf = (rng.standard_normal((8, 24, 32)) * rng.uniform(0.01, 50, (8, 24, 1))).astype(np.float32)
    mask = rng.random((8, 24)) < 0.6
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jbuf = jnp.asarray(buf).astype(jdtype)
    pbuf = torch.from_numpy(buf).to(dtype).requires_grad_()
    jy = jax.jit(jcodec.get_codec(name).apply)(jbuf, jnp.asarray(mask))
    py = get_codec(name).apply(pbuf, torch.from_numpy(mask))
    np.testing.assert_array_equal(py.detach().float().numpy(), np.asarray(jy, np.float32))
    # d/dbuf of sum(apply(buf)^2): 2 * apply(buf) through the straight-through seam
    jg = jax.jit(jax.grad(lambda b: (jcodec.get_codec(name).apply(b, jnp.asarray(mask)).astype(jnp.float32) ** 2).sum()))(jbuf)
    (get_codec(name).apply(pbuf, torch.from_numpy(mask)).float() ** 2).sum().backward()
    np.testing.assert_array_equal(pbuf.grad.float().numpy(), np.asarray(jg, np.float32))


# ---------------------------------------------------------- the MoE wire legs
@pytest.mark.parametrize("name", ["fp8", "int8"])
def test_dispatch_leg_equals_the_reference_bit_for_bit(name):
    """pack (the virtual fabric's wire mask) + wire encode on identical
    tokens and routing: buffer, mask and slots bit for bit."""
    rng = np.random.default_rng(4)
    t = 128
    x = rng.standard_normal((t, 32)).astype(np.float32) * rng.uniform(0.1, 10, (t, 1)).astype(np.float32)
    idx = np.argsort(-rng.standard_normal((t, 8)), axis=1)[:, :2].astype(np.int32)
    gates = rng.random((t, 2)).astype(np.float32)
    prow, jrow = _rows(2)
    jctx = JaxContext(cfg=_jcfg("phase_pipelined", wire_dtype=name), n=1, e_local=8, axis=None, me=None,
                      schedule=jrow, t_local=t)
    jfab = jax_get_fabric("dense")

    @jax.jit
    def jax_leg(x, idx, gates):
        packed = jfab.wire_encode(jctx, jfab.pack(jctx, x, idx, gates))
        return packed.buf, packed.wire, packed.live, packed.pos

    jbuf, jwire, jlive, jpos = jax_leg(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates))
    fab, ctx = DenseFabric(), FabricContext(cfg=_pcfg("phase_pipelined", wire_dtype=name), schedule=prow)
    packed = fab.pack(ctx, torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(gates))
    encoded = fab.wire_encode(ctx, packed)
    np.testing.assert_array_equal(packed.wire.numpy(), np.asarray(jwire))
    np.testing.assert_array_equal(packed.live.numpy(), np.asarray(jlive))
    np.testing.assert_array_equal(packed.pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(_bits(encoded.buf.numpy()), _bits(jbuf))
    assert 0 < int(packed.wire.sum()) < int(packed.live.sum())
    # the combine leg QDQs the same slots
    y = torch.from_numpy(rng.standard_normal(tuple(packed.buf.shape)).astype(np.float32))
    jy = jax.jit(lambda v: jfab.wire_decode(jctx, jfab.pack(jctx, jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates)), v))(
        jnp.asarray(y.numpy()))
    np.testing.assert_array_equal(_bits(fab.wire_decode(ctx, packed, y).numpy()), _bits(jy))


def _run(monkeypatch, dtype, name, wire):
    """(port y, stats, largest expert output), (JAX y, stats) for one fabric."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jdtype)
    params, p = _params(dtype)
    x = _x()
    prow, jrow = _rows(2) if name in ROW_FABRICS else (None, None)
    peaks = []
    real_ffn = pmoe._expert_ffn

    def recording_ffn(*args):
        out = real_ffn(*args)
        peaks.append(float(out.float().abs().max()))
        return out

    with monkeypatch.context() as mp:
        mp.setattr(pmoe, "_expert_ffn", recording_ffn)
        y, st = pmoe.moe_apply(p, _pcfg(name, wire_dtype=wire), torch.from_numpy(x).to(dtype), schedule=prow,
                               return_stats=True)
    jcfg = _jcfg(name, wire_dtype=wire)
    jy, jst = jax.jit(lambda prm, v: jax_moe.moe_apply(prm, jcfg, v, schedule=jrow, return_stats=True))(
        params, jnp.asarray(x).astype(jdtype))
    return (y.float().numpy(), st, max(peaks)), (np.asarray(jy, np.float32), jst)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", ["dense", "phase_pipelined", "ragged_a2a"])
@pytest.mark.parametrize("wire", ["fp8", "int8"])
def test_moe_apply_under_a_quantized_wire_matches_the_reference(monkeypatch, dtype, tol, name, wire):
    (y, st, peak), (jy, jst) = _run(monkeypatch, dtype, name, wire)
    (y16, st16, _), (jy16, _) = _run(monkeypatch, dtype, name, "bf16")
    # within one combine-leg codec step of the reference, plus the layer's own tolerance
    step = get_codec(wire).max_step_over_amax * peak if name in ROW_FABRICS else 0.0
    assert (np.abs(y - jy) <= tol + tol * np.abs(jy) * (dtype == torch.bfloat16) + step).all(), (
        name, wire, float(np.abs(y - jy).max()), step)
    for key in ("routing", "dropped"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]), err_msg=key)
        np.testing.assert_array_equal(st[key].numpy(), st16[key].numpy(), err_msg=key)
    assert float(st["admitted"]) == float(st16["admitted"]) and float(st["dropped"].sum()) == 0.0
    err, jerr = float(np.abs(y - y16).max()), float(np.abs(jy - jy16).max())
    if name in ROW_FABRICS:  # a table row marks cross-virtual-rank slots: the codec engages in both packages
        assert err > 0.0 and jerr > 0.0, (name, wire, err, jerr)
    else:  # no wire mask on one device: both outputs are bit-exact with the bf16 wire's
        assert err == 0.0 and jerr == 0.0, (name, wire, err, jerr)


@pytest.mark.parametrize("wire", ["fp8", "int8"])
def test_grads_under_a_quantized_wire_track_the_reference(monkeypatch, wire):
    """STE gradients of ``sum(moe_apply(x)^2)`` with respect to every
    weight, port against JAX under the same wire, within the bound the
    reference's own test puts on quantized against bf16 grads (fp8 0.08,
    int8 0.03 of the bf16 grads' max magnitude): both sides see the same
    STE, and their forward values differ by at most one combine-leg step."""
    monkeypatch.setattr(jax_layers, "COMPUTE_DTYPE", jnp.float32)
    params, p = _params(torch.float32)
    prow, jrow = _rows(2)
    x = _x()
    jcfg = _jcfg("phase_pipelined", wire_dtype=wire)
    jg = jax.jit(jax.grad(lambda prm: (jax_moe.moe_apply(prm, jcfg, jnp.asarray(x), schedule=jrow) ** 2).sum()))(params)
    jg16 = jax.jit(jax.grad(lambda prm: (jax_moe.moe_apply(prm, _jcfg("phase_pipelined"), jnp.asarray(x),
                                                            schedule=jrow) ** 2).sum()))(params)
    p.requires_grad_(True)
    (pmoe.moe_apply(p, _pcfg("phase_pipelined", wire_dtype=wire), torch.from_numpy(x), schedule=prow) ** 2).sum().backward()
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(jg16))
    rtol = {"fp8": 0.08, "int8": 0.03}[wire]
    for got, ref in ((p.router.grad, jg["router"]["w"]), (p.w_gate.grad, jg["w_gate"]), (p.w_up.grad, jg["w_up"]),
                     (p.w_down.grad, jg["w_down"])):
        assert torch.isfinite(got).all()
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) <= rtol * scale


@pytest.mark.parametrize("name", ["dense", "phase_pipelined"])
def test_explicit_bf16_wire_is_bit_exact(name):
    _, p = _params(torch.float32)
    prow = _rows(2)[0] if name != "dense" else None
    x = torch.from_numpy(_x())
    y_def = pmoe.moe_apply(p, _pcfg(name), x, schedule=prow)
    y_bf16 = pmoe.moe_apply(p, _pcfg(name, wire_dtype="bf16"), x, schedule=prow)
    assert torch.equal(y_def, y_bf16)


@pytest.mark.parametrize("use_row", [True, False])
def test_unknown_wire_dtype_raises_listing_codecs(use_row):
    _, p = _params(torch.float32)
    prow = _rows(2)[0] if use_row else None
    with pytest.raises(ValueError, match="bf16, fp8, int8"):
        pmoe.moe_apply(p, _pcfg("phase_pipelined", wire_dtype="fp4"), torch.from_numpy(_x()), schedule=prow)


def test_dense_dispatch_bytes_as_the_reference():
    """The virtual fabric ships no dispatch slot; bytes price slots at
    ``wire_bytes_per_token`` (8192 a bf16 slot at d 4096, 4100 fp8/int8)."""
    jfab = jax_get_fabric("dense")
    for wire in ("bf16", "fp8", "int8"):
        kw = dict(d_model=4096, wire_dtype=wire, n=8, cap_uniform=64)
        assert DenseFabric().dispatch_bytes(**kw) == jfab.dispatch_bytes(**kw) == 0.0
    assert DenseFabric().dispatch_tokens(n=8) == jfab.dispatch_tokens(n=8) == 0.0

    class OneSlot(DenseFabric):
        def dispatch_tokens(self, **kw):
            return 1.0

    assert [OneSlot().dispatch_bytes(d_model=4096, wire_dtype=w, n=8) for w in ("bf16", "fp8", "int8")] == [
        8192.0, 4100.0, 4100.0]
