"""Fabric-geometry parity: admission, packing and stats of the port's
virtual fabric against ``repro.parallel.fabric.geometry`` on the same
routing.  All integer/boolean results must be equal; the f32 combine
scatter-add may sum in another order (stated tolerance below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ScheduleTable as JaxTable
from repro.core import decompose as jax_decompose
from repro.core import plan_schedule as jax_plan
from repro.parallel.fabric import geometry as jg

from repro_torch.core import ScheduleTable, decompose, plan_schedule
from repro_torch.parallel.fabric import geometry as pg

N_EXPERTS, TOP_K = 8, 2


def _routing(t: int, seed: int):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, N_EXPERTS))
    idx = np.argsort(-logits, axis=1)[:, :TOP_K].astype(np.int32)
    gates = rng.random((t, TOP_K)).astype(np.float32)
    x = rng.standard_normal((t, 16)).astype(np.float32)
    return idx, gates, x


def _rows(n_ranks: int, seed: int, scale: float):
    rng = np.random.default_rng(seed)
    m = rng.integers(1, 60, size=(n_ranks, n_ranks)).astype(np.float64) * scale
    m *= rng.random((n_ranks, n_ranks)) < 0.6  # dark pairs: cap 0, every choice clipped
    port = ScheduleTable.from_schedules([plan_schedule(decompose(m, "maxweight", min_fill=0.1))], envelope="auto")
    ref = JaxTable.from_schedules([jax_plan(jax_decompose(m, "maxweight", min_fill=0.1))], envelope="auto")
    return port.row(0), ref.row(0)


@pytest.mark.parametrize("t,seed", [(64, 0), (256, 1), (40, 2)])
@pytest.mark.parametrize("n_ranks", [8, 4])
@pytest.mark.parametrize("scale", [0.05, 1.0])
def test_admission_mask_equal(t, seed, n_ranks, scale):
    idx, gates, _ = _routing(t, seed)
    prow, jrow = _rows(n_ranks, seed, scale)
    tok = np.arange(t * TOP_K) // TOP_K
    src = (tok * n_ranks) // t
    g_p, a_p = pg.admission_mask(torch.from_numpy(idx), torch.from_numpy(gates), prow, N_EXPERTS,
                                 src=torch.from_numpy(src))
    g_j, a_j = jg.admission_mask(jnp.asarray(idx), jnp.asarray(gates), jrow, N_EXPERTS,
                                 src=jnp.asarray(src, jnp.int32))
    np.testing.assert_array_equal(a_p.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
    assert not a_p.all(), "dark pairs must clip some choices"


@pytest.mark.parametrize("t,cap,seed", [(64, 24, 0), (64, 8, 1), (100, 32, 2)])
def test_group_tokens_and_stats_equal(t, cap, seed):
    idx, gates, x = _routing(t, seed)
    rng = np.random.default_rng(seed + 100)
    admitted = rng.random(t * TOP_K) < 0.8
    key = idx.reshape(-1)
    buf_p, pos_p, gate_p, live_p = pg.group_tokens(
        torch.from_numpy(x), torch.from_numpy(key), torch.from_numpy(gates.reshape(-1)), N_EXPERTS, cap,
        admitted=torch.from_numpy(admitted),
    )
    buf_j, pos_j, gate_j, live_j = jg.group_tokens(
        jnp.asarray(x), jnp.asarray(key), jnp.asarray(gates.reshape(-1)), N_EXPERTS, cap,
        admitted=jnp.asarray(admitted),
    )
    np.testing.assert_array_equal(pos_p.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(live_p.numpy(), np.asarray(live_j))
    np.testing.assert_array_equal(gate_p.numpy(), np.asarray(gate_j))
    np.testing.assert_array_equal(buf_p.numpy(), np.asarray(buf_j))

    counts_p = pg.routing_counts(torch.from_numpy(idx), N_EXPERTS)[None, :]
    counts_j = jg.routing_counts(jnp.asarray(idx), N_EXPERTS)[None, :]
    st_p = pg.stats_tree(counts_p, torch.from_numpy(admitted), live_p)
    st_j = jg.stats_tree(counts_j, jnp.asarray(admitted), live_j)
    for name in ("routing", "dropped"):
        np.testing.assert_array_equal(st_p[name].numpy(), np.asarray(st_j[name]), err_msg=name)
    assert float(st_p["admitted"]) == float(admitted.sum())

    # combine: f32 scatter-add; two choices per token summed in possibly
    # another order, so allow f32 rounding (1e-6 relative)
    y = rng.standard_normal((N_EXPERTS, cap, 16)).astype(np.float32)
    out_p = pg.ungroup(torch.from_numpy(y), pos_p, gate_p, t)
    out_j = jg.ungroup(jnp.asarray(y), pos_j, gate_j, t)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_rank_in_group_equal():
    key = np.random.default_rng(5).integers(0, 7, size=300).astype(np.int32)
    np.testing.assert_array_equal(
        pg.rank_in_group(torch.from_numpy(key)).numpy(), np.asarray(jg.rank_in_group(jnp.asarray(key)))
    )


def test_round8_equal():
    for v in (0, 1, 8, 9, 320, 321):
        assert pg.round8(v) == jg.round8(v)


@pytest.mark.parametrize("name", ["a2a", "dense", "ppermute", "phase_pipelined", "ragged_a2a", "hierarchical",
                                  "scheduled"])
def test_consumes_schedule_and_table_answer_as_the_jax_registry(name):
    """The training loop's fail-fast checks key on these two answers."""
    import repro.parallel.fabric as jax_fabric

    from repro_torch.parallel.fabric import consumes_schedule, consumes_table

    assert consumes_schedule(name) == jax_fabric.consumes_schedule(name)
    assert consumes_table(name) == jax_fabric.consumes_table(name)


def test_consumes_schedule_rejects_unknown_names_as_jax_does():
    import repro.parallel.fabric as jax_fabric

    from repro_torch.parallel.fabric import consumes_schedule, consumes_table

    for fn in (consumes_schedule, consumes_table, jax_fabric.consumes_schedule, jax_fabric.consumes_table):
        with pytest.raises(ValueError, match="unknown dispatch mode"):
            fn("carrier_pigeon")
