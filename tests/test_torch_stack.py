"""Which schedule-table row each layer of the stack takes: the port's
``moe_rows`` against the layout the JAX stack scans over
(``repro.models.stack.moe_positions``: rows as [period, MoE position in
the period]), for Mixtral's smoke config (every layer MoE) and one with
``moe.every = 2`` (every second layer MoE, the rest dense)."""

import dataclasses

import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models.stack import moe_positions

from repro_torch.configs import smoke_config
from repro_torch.core.schedule import ScheduleTable
from repro_torch.models.stack import moe_rows, schedule_rows


def _cfgs(every: int, n_layers: int):
    jcfg, pcfg = jax_smoke("mixtral-8x7b"), smoke_config("mixtral-8x7b")
    jcfg = dataclasses.replace(jcfg, n_layers=n_layers, moe=dataclasses.replace(jcfg.moe, every=every))
    pcfg = dataclasses.replace(pcfg, n_layers=n_layers, moe=dataclasses.replace(pcfg.moe, every=every))
    return jcfg, pcfg


def _jax_rows(jcfg) -> list:
    """Layer l = period p, position j: row p * len(positions) + positions.index(j)."""
    positions = moe_positions(jcfg)
    return [
        (l // jcfg.period) * len(positions) + positions.index(l % jcfg.period) if l % jcfg.period in positions
        else None
        for l in range(jcfg.n_layers)
    ]


def _table(n_rows: int, n: int = 4, k_max: int = 2) -> ScheduleTable:
    """A table whose row i has capacity i + 1 in every phase."""
    perms = torch.arange(n, dtype=torch.int32).expand(n_rows, k_max, n).contiguous()
    caps = torch.arange(1, n_rows + 1, dtype=torch.int32)[:, None].expand(n_rows, k_max).contiguous()
    return ScheduleTable(
        perms=perms, caps=caps, valid=torch.ones((n_rows, k_max, n), dtype=torch.bool),
        offsets=torch.zeros((n_rows, k_max, n), dtype=torch.int32),
        n_phases=torch.full((n_rows,), k_max, dtype=torch.int32),
    )


@pytest.mark.parametrize("every,n_layers", [(1, None), (2, 4), (2, 6)])
def test_layers_take_the_rows_of_their_moe_positions(every, n_layers):
    jcfg, pcfg = _cfgs(every, n_layers or smoke_config("mixtral-8x7b").n_layers)
    want = _jax_rows(jcfg)
    assert moe_rows(pcfg) == want
    assert sum(r is not None for r in want) == pcfg.n_moe_layers
    rows = schedule_rows(_table(pcfg.n_moe_layers), pcfg)
    assert len(rows) == pcfg.n_layers
    for row, i in zip(rows, want):
        if i is None:
            assert row is None
        else:
            assert row.is_row and int(row.caps[0]) == i + 1


def test_schedule_rows_rejects_a_table_of_the_wrong_depth():
    _, pcfg = _cfgs(2, 4)
    with pytest.raises(ValueError, match="2 MoE layers"):
        schedule_rows(_table(4), pcfg)
    assert schedule_rows(None, pcfg) == [None] * 4
