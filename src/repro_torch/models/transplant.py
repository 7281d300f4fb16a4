"""Weight transplant between the JAX ``Model.init`` pytree and the port's
``Model``, both ways.

PyTorch cannot replay ``jax.random``, so parity runs load the JAX
package's parameters.  The pytree is numpy arrays, ``{"embed":
{"table"}, "head": {"w"}, "ln_f": {"scale"}, "stack": {"pos0": {...}}}``
with block leaves stacked over ``n_periods`` (one block per period: the
port's two block kinds, Mixtral's attention + MoE and RWKV6, each have
one).  ``load_reference`` stores the weights JAX casts before use in
``param_dtype`` (default: the compute dtype; ``torch.float32`` for
training masters); the router, the norm scales and RWKV6's mixes, LoRA
weights, decay base and bonus stay f32.  Every key is consumed; a
leftover raises.
``to_reference`` rebuilds that pytree from a model's parameters, or
from their gradients, so tests compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv
from repro_torch.models.model import Model

__all__ = ["load_reference", "to_reference"]

# block kind -> port attribute path -> (JAX pytree path inside one block, keep f32?)
_BLOCK_LEAVES = {
    "attn": {
        "ln1": (("ln1", "scale"), True),
        "ln2": (("ln2", "scale"), True),
        "mixer.q": (("mixer", "q", "w"), False),
        "mixer.k": (("mixer", "k", "w"), False),
        "mixer.v": (("mixer", "v", "w"), False),
        "mixer.o": (("mixer", "o", "w"), False),
        "ffn.router": (("ffn", "router", "w"), True),
        "ffn.w_gate": (("ffn", "w_gate"), False),
        "ffn.w_up": (("ffn", "w_up"), False),
        "ffn.w_down": (("ffn", "w_down"), False),
    },
    "rwkv6": {
        "ln1": (("ln1", "scale"), True),
        "ln2": (("ln2", "scale"), True),
        **{
            f"mixer.{n}": (("mixer", n), True)
            for n in ("mu", "mix_w1", "mix_w2", "w0", "decay_w1", "decay_w2", "u", "cm_mu_k", "cm_mu_r")
        },
        "mixer.ln_x_scale": (("mixer", "ln_x", "scale"), True),
        "mixer.ln_x_bias": (("mixer", "ln_x", "bias"), True),
        **{f"mixer.{n}": (("mixer", n, "w"), False) for n in rwkv.DENSE},
    },
}
_TOP_LEAVES = {
    "embed": (("embed", "table"), False),
    "head": (("head", "w"), False),
    "ln_f": (("ln_f", "scale"), True),
}


def _flatten(tree, prefix=()) -> dict[tuple, np.ndarray]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def load_reference(
    cfg: ModelConfig, tree: dict, *, device=None, dtype=torch.bfloat16, param_dtype=None,
    requires_grad: bool = False,
) -> Model:
    """A ``Model`` holding the JAX parameters ``tree`` (numpy leaves)."""
    model = Model(cfg, device=device, dtype=dtype, param_dtype=param_dtype, seed=None, requires_grad=requires_grad)
    stored = model.param_dtype
    leaves = _flatten(tree)
    if cfg.moe is not None and cfg.moe.every != 1:
        raise NotImplementedError("transplant covers one block per period (Mixtral, RWKV6)")

    def put(param: torch.nn.Parameter, arr: np.ndarray, keep_f32: bool, name: str):
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference {arr.shape} vs port {tuple(param.shape)}")
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        param.data.copy_(t.to(torch.float32 if keep_f32 else stored))

    for attr, (path, keep) in _TOP_LEAVES.items():
        put(getattr(model, attr), leaves.pop(path), keep, "/".join(path))
    for attr, (path, keep) in _BLOCK_LEAVES[cfg.layer_kind(0)].items():
        full = ("stack", "pos0") + path
        stacked = leaves.pop(full)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"{'/'.join(full)}: {stacked.shape[0]} layers, config has {cfg.n_layers}")
        for l, block in enumerate(model.layers):
            param = block.get_parameter(attr)
            put(param, stacked[l], keep, "/".join(full) + f"[{l}]")
    if leaves:
        raise ValueError(f"unconsumed reference leaves: {sorted('/'.join(k) for k in leaves)}")
    return model


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def to_reference(model_or_grads) -> dict:
    """The JAX pytree layout (numpy f32 leaves) of a ``Model``'s parameters
    or of a ``{name: tensor}`` dict keyed like ``model.named_parameters()``
    (e.g. their gradients).  Block leaves are stacked over layers."""
    if isinstance(model_or_grads, Model):
        named = dict(model_or_grads.named_parameters())
    else:
        named = dict(model_or_grads)

    def arr(name):
        return named.pop(name).detach().float().cpu().numpy()

    tree: dict = {}
    for attr, (path, _) in _TOP_LEAVES.items():
        _set(tree, path, arr(attr))
    n_layers = 1 + max(int(k.split(".")[1]) for k in named if k.startswith("layers."))
    # the block kind whose leaves layer 0 holds
    block = next((b for b in _BLOCK_LEAVES.values() if all(f"layers.0.{attr}" in named for attr in b)), None)
    if block is None:
        raise ValueError("layer 0's parameters match no ported block kind")
    for attr, (path, _) in block.items():
        _set(tree, ("stack", "pos0") + path, np.stack([arr(f"layers.{l}.{attr}") for l in range(n_layers)]))
    if named:
        raise ValueError(f"parameters with no reference leaf: {sorted(named)}")
    return tree
