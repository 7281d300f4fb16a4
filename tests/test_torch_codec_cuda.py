"""The fp8/int8 wire codecs on the card: bit for bit with the CPU, inside
a captured CUDA graph, and on the MoE layer's virtual fabric.  Skips
without a CUDA device; imports no JAX.  Run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_codec_cuda.py

Every step of the codec is a correctly rounded elementwise operation or
a max, so the card's bits are the CPU's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import make_serving_controller
from repro_torch.launch.serve import demand_estimate
from repro_torch.models import moe as pmoe
from repro_torch.parallel.fabric import get_codec


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _slots(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(96, 4096)) * 10.0 ** rng.integers(-8, 8, (96, 1))
    x[:4] = 0.0  # padding slots
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp8", "int8"])
def test_codec_on_the_card_equals_the_cpu(cuda_device, name):
    codec = get_codec(name)
    for seed in range(3):
        x = _slots(seed)
        q, scale = codec.encode(x)
        qc, sc = codec.encode(x.to(cuda_device))
        assert torch.equal(sc.cpu(), scale)
        assert torch.equal(qc.cpu().view(torch.uint8), q.view(torch.uint8))
        mask = torch.from_numpy(np.random.default_rng(seed).random(96) < 0.5)
        for dtype in (torch.float32, torch.bfloat16):
            cpu = codec.apply(x.to(dtype), mask)
            card = codec.apply(x.to(dtype).to(cuda_device), mask.to(cuda_device))
            assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp8", "int8"])
def test_codec_replays_in_a_cuda_graph(cuda_device, name):
    """No host read on the wire path: the encode/decode pair captures,
    and a replay on new slots equals the eager call."""
    codec = get_codec(name)
    buf = _slots(0).to(torch.bfloat16).to(cuda_device)
    mask = torch.ones(96, dtype=torch.bool, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        codec.apply(buf, mask)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = codec.apply(buf, mask)
    buf.copy_(_slots(1).to(torch.bfloat16).to(cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, codec.apply(buf, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["fp8", "int8"])
def test_moe_layer_wire_engages_on_the_card(cuda_device, monkeypatch, wire):
    """Smoke Mixtral's MoE layer under the serving controller's row: the
    stats equal the bf16 wire's, the output moves, and the card's K1 path
    equals its plain path within K1's tolerance (2e-2 + 2e-2·|plain|) and
    one combine-leg codec step at the largest expert output."""
    from repro_torch.kernels.moe_gemm import ops as k1

    cfg = smoke_config("mixtral-8x7b")
    cfg = dataclasses.replace(cfg, n_layers=1, moe=dataclasses.replace(cfg.moe, dispatch="phase_pipelined"))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    layer = pmoe.moe_init(cfg, gen=gen, device=cuda_device, dtype=torch.bfloat16)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda_device).to(torch.bfloat16)
    rt, scen = make_serving_controller(cfg, n_ranks=8, drift="none", device=cuda_device)
    rt.observe(demand_estimate(cfg, float(4 * 64 * cfg.moe.top_k), scen, 0))
    row = rt.table().row(0)
    y16, st16 = pmoe.moe_apply(layer, cfg, x, schedule=row, return_stats=True)
    qcfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, wire_dtype=wire))
    peaks, real_ffn = [], pmoe._expert_ffn

    def recording_ffn(*args):
        out = real_ffn(*args)
        peaks.append(float(out.float().abs().max()))
        return out

    monkeypatch.setattr(pmoe, "_expert_ffn", recording_ffn)
    y, st = pmoe.moe_apply(layer, qcfg, x, schedule=row, return_stats=True)
    for key in ("routing", "dropped", "admitted"):
        assert torch.equal(st[key], st16[key]), key
    assert float((y.float() - y16.float()).abs().max()) > 0.0
    monkeypatch.setattr(k1, "moe_gemm", k1.moe_gemm_plain)
    y_plain = pmoe.moe_apply(layer, qcfg, x, schedule=row)
    step = get_codec(wire).max_step_over_amax * max(peaks)
    diff = (y.float() - y_plain.float()).abs() - 2e-2 * y_plain.float().abs()
    assert float(diff.max()) <= 2e-2 + step
