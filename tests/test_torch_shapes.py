"""The port's shape cells (``repro_torch.launch.shapes``) against the JAX
package's (``repro.launch.shapes``): the cells, which configs each cell
applies to, the input specs (JAX's ``ShapeDtypeStruct`` shapes and dtypes,
here tensors on the ``meta`` device), and the ``subquadratic`` flag the
long-context cell reads, for every config the port has ported.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import shapes as jax_shapes

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch import shapes

PORTED = sorted(ARCHS)
DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def test_cells_equal_jax():
    assert list(shapes.CELLS) == list(jax_shapes.CELLS)
    for name, cell in shapes.CELLS.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(jax_shapes.CELLS[name])


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("cell", list(jax_shapes.CELLS))
def test_cell_applicable_equals_jax(arch, cell):
    assert shapes.cell_applicable(get_config(arch), shapes.CELLS[cell]) == jax_shapes.cell_applicable(
        jax_config(arch), jax_shapes.CELLS[cell]
    )


def test_long_500k_applies_to_rwkv_only():
    """The sub-quadratic configs run the 500k-token cell: RWKV6's and Jamba's O(1) decode states and
    h2o-danube's window-bounded cache; the full-attention configs are excluded."""
    long = shapes.CELLS["long_500k"]
    assert {arch: shapes.cell_applicable(get_config(arch), long)[0] for arch in PORTED} == {
        arch: arch in ("rwkv6-7b", "h2o-danube-3-4b", "jamba-1.5-large-398b") for arch in PORTED
    }


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("cell", list(jax_shapes.CELLS))
def test_input_specs_equal_jax(arch, cell, smoke):
    from repro.configs import smoke_config as jax_smoke

    pcfg = smoke_config(arch) if smoke else get_config(arch)
    jcfg = jax_smoke(arch) if smoke else jax_config(arch)
    got = shapes.input_specs(pcfg, shapes.CELLS[cell])
    want = jax_shapes.input_specs(jcfg, jax_shapes.CELLS[cell])
    assert list(got) == list(want)
    for key, spec in want.items():
        assert got[key].device.type == "meta", key
        assert tuple(got[key].shape) == tuple(spec.shape) and got[key].dtype == DTYPES[jnp.dtype(spec.dtype)], key


@pytest.mark.parametrize("arch", PORTED)
def test_configs_carry_subquadratic_as_jax(arch):
    assert get_config(arch).subquadratic == jax_config(arch).subquadratic
    assert smoke_config(arch).subquadratic == jax_config(arch).subquadratic
