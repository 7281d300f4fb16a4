"""Train step factory: loss and gradients with microbatch accumulation,
then AdamW.  Counterpart of ``repro/train/train_step.py``
``make_train_step`` without the sharding rules (one device) and without
gradient compression or the fused device controller, which are not
ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["make_train_step"]


def make_train_step(model, optimizer, *, microbatches: int = 1, collect_routing: bool = False,
                    grad_compress: str | None = None, controller=None):
    """Returns ``train_step(batch, schedule=None) -> metrics``, updating
    ``model``'s parameters in place; the step's closure holds the
    optimizer state.

    ``batch`` holds ``tokens`` / ``targets`` [B, S] (tensors or numpy);
    ``schedule`` is None or a ``ScheduleTable`` with one row per MoE
    layer.  ``microbatches`` > 1 splits the batch and sums the gradients,
    then scales loss and gradients by ``1 / microbatches``, as JAX's scan
    does.  ``metrics``: ``loss``, ``grad_norm`` (0-dim tensors on the
    device), ``lr`` and, with ``collect_routing``, ``moe_stats`` summed
    over microbatches."""
    if grad_compress is not None:
        raise NotImplementedError(f"grad_compress={grad_compress!r}: error-feedback compression is not ported yet (ROADMAP)")
    if controller is not None:
        raise NotImplementedError("the fused device-controller train step is not ported yet (ROADMAP)")
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if not params:
        raise ValueError("the model has no parameter that requires grad: build it with requires_grad=True")

    def loss_fn(batch, schedule):
        if collect_routing:
            return model.loss_and_stats(batch, schedule=schedule)
        return model.loss(batch, schedule=schedule), None

    opt_state = optimizer.init(params, ranks=model.reference_ranks())

    def train_step(batch: dict, schedule=None) -> dict:
        nonlocal opt_state
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        mb = b // microbatches
        for p in params.values():
            p.grad = None
        loss_sum = aux_sum = None
        for i in range(microbatches):
            loss, aux = loss_fn({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}, schedule)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            if aux is not None:
                aux_sum = aux if aux_sum is None else {k: aux_sum[k] + aux[k] for k in aux}
        grads = {n: p.grad for n, p in params.items()}
        if microbatches > 1:
            scale = 1.0 / microbatches
            loss_sum = loss_sum * scale
            for g in grads.values():
                g.mul_(scale)
        _, opt_state, stats = optimizer.update(grads, opt_state, params)
        for p in params.values():
            p.grad = None  # the gradients' memory is free until the next backward
        metrics = {"loss": loss_sum, **stats}
        if collect_routing:
            metrics["moe_stats"] = aux_sum
        return metrics

    return train_step
