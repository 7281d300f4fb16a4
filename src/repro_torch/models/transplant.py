"""Weight transplant between the JAX ``Model.init`` pytree and the port's
``Model``, both ways.

PyTorch cannot replay ``jax.random``, so parity runs load the JAX
package's parameters.  The pytree is numpy arrays, ``{"embed":
{"table"}, "head": {"w"} (absent with tied embeddings), "ln_f":
{"scale"}, "stack": {"pos0": {...}, ..., "pos{period-1}": {...}}}``,
each period position's block leaves stacked over ``n_periods``: leaf
``stack/pos{j}`` [n_periods, ...] holds layer ``p * period + j`` at
index p (one position for Mixtral and RWKV6, eight for Jamba).
``load_reference`` stores the weights JAX casts before use in
``param_dtype`` (default: the compute dtype; ``torch.float32`` for
training masters); the router, the norm scales, a tied embedding table,
Mamba's ``a_log`` / ``dt_bias`` / ``d_skip`` and RWKV6's mixes, LoRA
weights, decay base and bonus stay f32.  Every key is consumed and every
port parameter set; a leftover on either side raises.
``to_reference`` rebuilds that pytree from a model's parameters, or
from their gradients, so tests compare leaf by leaf.

Across EP ranks, ``load_reference(..., rank=, n_model=)`` keeps rank
``rank``'s contiguous slice of each MoE layer's experts (expert ``e`` on
rank ``e // e_local``), and ``to_reference(..., world=)`` all-gathers the
slices back over the world's model group.  Under 2D expert sharding
``ffn_shard=(index, n_data)`` also keeps data group ``index``'s slice of
each expert's FFN width (the last axis of ``w_gate``/``w_up``, axis 1 of
``w_down``: JAX's ``P(EP, None, "data")`` and ``P(EP, "data", None)``),
and ``to_reference`` gathers a model holding such slices over the data
group first.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv
from repro_torch.models.model import Model

__all__ = ["load_reference", "to_reference"]

# module kind -> port attribute -> JAX pytree path inside the module (the
# port module fixes each parameter's dtype: the storage dtype or f32)
_MIXER_LEAVES = {
    "attn": {
        **{n: (n, "w") for n in ("q", "k", "v", "o")},
        **{f"{n}_bias": (n, "b") for n in ("q", "k", "v")},
    },
    "mamba": {
        **{n: (n, "w") for n in ("in_proj", "x_proj", "dt_proj", "out_proj")},
        **{n: (n,) for n in ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip")},
    },
    "rwkv6": {
        **{n: (n,) for n in ("mu", "mix_w1", "mix_w2", "w0", "decay_w1", "decay_w2", "u", "cm_mu_k", "cm_mu_r")},
        "ln_x_scale": ("ln_x", "scale"),
        "ln_x_bias": ("ln_x", "bias"),
        **{n: (n, "w") for n in rwkv.DENSE},
    },
}
_FFN_LEAVES = {
    "moe": {
        "router": ("router", "w"),
        **{n: (n,) for n in ("w_gate", "w_up", "w_down")},
    },
    "swiglu": {n: (n, "w") for n in ("w_gate", "w_up", "w_down")},
    "gelu": {n: (n, "w") for n in ("w_up", "w_down")},
}
# the attribute that tells a module kind apart, in the order they are tried
_MIXER_MARK = {"attn": "mixer.q", "mamba": "mixer.in_proj", "rwkv6": "mixer.wr"}
_FFN_MARK = {"moe": "ffn.router", "swiglu": "ffn.w_gate", "gelu": "ffn.w_up"}


def _top_leaves(names) -> dict:
    out = {"embed": ("embed", "table"), "ln_f": ("ln_f", "scale")}
    if "head" in names:
        out["head"] = ("head", "w")
    return out


def _block_leaves(names) -> dict:
    """Port attribute (``ln1``, ``mixer.q``, ...) -> JAX path inside one
    block, for a block with the parameter names ``names``."""
    mixer = next((k for k, mark in _MIXER_MARK.items() if mark in names), None)
    if mixer is None:
        raise ValueError(f"a block whose parameters {sorted(names)} match no ported mixer")
    out = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale")}
    out.update({f"mixer.{a}": ("mixer",) + path for a, path in _MIXER_LEAVES[mixer].items()})
    ffn = next((k for k, mark in _FFN_MARK.items() if mark in names), None)
    if ffn is not None:
        out.update({f"ffn.{a}": ("ffn",) + path for a, path in _FFN_LEAVES[ffn].items()})
    return {a: v for a, v in out.items() if a in names}


def _flatten(tree, prefix=()) -> dict[tuple, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


_EXPERT_LEAVES = ("ffn.w_gate", "ffn.w_up", "ffn.w_down")


def _is_expert_leaf(attr: str, names) -> bool:
    """A block attribute that holds one MoE layer's experts."""
    return attr in _EXPERT_LEAVES and "ffn.router" in names


def load_reference(
    cfg: ModelConfig, tree: dict, *, device=None, dtype=torch.bfloat16, param_dtype=None,
    requires_grad: bool = False, rank: int | None = None, n_model: int | None = None,
    ffn_shard: tuple[int, int] | None = None,
) -> Model:
    """A ``Model`` holding the JAX parameters ``tree`` (numpy leaves);
    with ``rank``/``n_model``, only that EP rank's experts, and with
    ``ffn_shard`` (index, n_data) only that slice of their FFN width."""
    shard = None if n_model is None else (rank, n_model)
    model = Model(cfg, device=device, dtype=dtype, param_dtype=param_dtype, seed=None, requires_grad=requires_grad,
                  expert_shard=shard, ffn_shard=ffn_shard)
    ffn_axes = model.ffn_axes()
    leaves = _flatten(tree)
    used, unset = set(), {n for n, _ in model.named_parameters()}

    def take(path: tuple) -> np.ndarray:
        if path not in leaves:
            raise ValueError(f"reference leaf {'/'.join(path)} missing")
        used.add(path)
        return leaves[path]

    def put(name: str, arr: np.ndarray, what: str):
        param = model.get_parameter(name)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{what}: reference {arr.shape} vs port {tuple(param.shape)}")
        param.data.copy_(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(param.dtype))
        unset.discard(name)

    names = {n for n, _ in model.named_parameters()}
    for attr, path in _top_leaves(names).items():
        put(attr, take(path), "/".join(path))
    period, n_periods = cfg.period, cfg.n_periods
    for l, block in enumerate(model.layers):
        p, j = divmod(l, period)
        bnames = {n for n, _ in block.named_parameters()}
        for attr, path in _block_leaves(bnames).items():
            full = ("stack", f"pos{j}") + path
            stacked = take(full)
            if stacked.shape[0] != n_periods:
                raise ValueError(f"{'/'.join(full)}: {stacked.shape[0]} periods, config has {n_periods}")
            arr = stacked[p]
            name = f"layers.{l}.{attr}"
            if shard is not None and _is_expert_leaf(attr, bnames):
                e_local = arr.shape[0] // n_model
                arr = arr[rank * e_local:(rank + 1) * e_local]
            if name in ffn_axes:
                axis = ffn_axes[name]
                f_local = arr.shape[axis] // ffn_shard[1]
                arr = np.take(arr, range(ffn_shard[0] * f_local, (ffn_shard[0] + 1) * f_local), axis=axis)
            put(name, arr, "/".join(full) + f"[{p}]")
    if set(leaves) - used:
        raise ValueError(f"unconsumed reference leaves: {sorted('/'.join(k) for k in set(leaves) - used)}")
    if unset:
        raise ValueError(f"port parameters with no reference leaf: {sorted(unset)}")
    return model


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_reference(model_or_grads, cfg: ModelConfig | None = None, *, world=None) -> dict:
    """The JAX pytree layout (numpy f32 leaves) of a ``Model``'s parameters
    or of a ``{name: tensor}`` dict keyed like ``model.named_parameters()``
    (e.g. their gradients; ``cfg`` gives the period, default 1).  Block
    leaves are stacked over periods.  With ``world`` (every rank of the
    world calls it) each rank's expert slices are all-gathered: over the
    data group along the FFN width first where a ``Model`` holds a slice
    of it (``Model.ffn_axes``, 2D), then over the model group."""
    ffn_axes = {}
    if isinstance(model_or_grads, Model):
        named, cfg = dict(model_or_grads.named_parameters()), model_or_grads.cfg
        ffn_axes = model_or_grads.ffn_axes()
    else:
        named = dict(model_or_grads)
    period = 1 if cfg is None else cfg.period
    if world is not None and world.size > 1:
        from repro_torch.parallel.collectives import all_gather_stats

        for name in sorted(named):
            if not name.startswith("layers."):
                continue
            _, layer, attr = name.split(".", 2)
            if attr in _EXPERT_LEAVES and f"layers.{layer}.ffn.router" in named:
                t = named[name].detach()
                if name in ffn_axes:
                    t = torch.cat(list(all_gather_stats(t, world.data_group)), dim=ffn_axes[name])
                if world.n > 1:
                    t = all_gather_stats(t, world.model_group).reshape(-1, *t.shape[1:])
                named[name] = t

    def arr(name):
        return named.pop(name).detach().float().cpu().numpy()

    tree: dict = {}
    for attr, path in _top_leaves(named).items():
        _set(tree, path, arr(attr))
    n_layers = 1 + max(int(k.split(".")[1]) for k in named if k.startswith("layers."))
    for j in range(period):
        layers = range(j, n_layers, period)
        block = _block_leaves({k.split(".", 2)[2] for k in named if k.startswith(f"layers.{j}.")})
        for attr, path in block.items():
            _set(tree, ("stack", f"pos{j}") + path, np.stack([arr(f"layers.{l}.{attr}") for l in layers]))
    if named:
        raise ValueError(f"parameters with no reference leaf: {sorted(named)}")
    return tree
