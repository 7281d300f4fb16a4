"""Train step factory: loss and gradients with microbatch accumulation,
optional error-feedback int8 gradient compression, then AdamW; or the
fused variant that steps the device-resident controller.  Counterpart of
``repro/train/train_step.py`` ``make_train_step`` without the sharding
rules (one device).
"""

from __future__ import annotations

import torch

from repro_torch.optim.compression import ef_int8_compress, ef_int8_init

__all__ = ["make_train_step"]


def make_train_step(model, optimizer, *, microbatches: int = 1, collect_routing: bool = False,
                    grad_compress: str | None = None, controller=None):
    """Returns ``train_step(batch, schedule=None) -> metrics``, updating
    ``model``'s parameters in place.  The step's state lives on it as
    ``train_step.state``: ``{"params", "opt", "ef"}``, the tensors the
    step updates in place (what a checkpoint saves and restores).

    ``batch`` holds ``tokens`` / ``targets`` [B, S] (tensors or numpy);
    ``schedule`` is None or a ``ScheduleTable`` with one row per MoE
    layer.  ``microbatches`` > 1 splits the batch and sums the gradients,
    then scales loss and gradients by ``1 / microbatches``, as JAX's scan
    does.  ``grad_compress="ef8"`` compresses the gradients with error
    feedback (``optim.compression``, one scale per JAX leaf) after that
    scale and before the update.  ``metrics``: ``loss``, ``grad_norm`` (0-dim tensors on the
    device), ``lr`` and, with ``collect_routing``, ``moe_stats`` summed
    over microbatches.

    ``controller`` (a ``core.DeviceController`` on the model's device)
    selects the fused variant, ``train_step(batch, ctrl_state) ->
    metrics``: the table is ``controller.table_of(ctrl_state)``, and after
    the update the step's routing feeds ``controller.step_device``, the
    device half of the transition, with no host read.  Its ``DeviceStep``
    is ``metrics["device_step"]`` (routing stats never appear in
    ``metrics``): the caller reads ``fire`` when it reads the loss and
    calls ``controller.replan`` before the next step, so the re-plan lands
    where JAX's in-graph ``lax.cond`` puts it."""
    if grad_compress not in (None, "ef8"):
        raise ValueError(f"grad_compress={grad_compress!r}: the port compresses with 'ef8' only")
    collect_routing = collect_routing or controller is not None
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    if not params:
        raise ValueError("the model has no parameter that requires grad: build it with requires_grad=True")

    def loss_fn(batch, schedule):
        if collect_routing:
            return model.loss_and_stats(batch, schedule=schedule)
        return model.loss(batch, schedule=schedule), None

    opt_state = optimizer.init(params, ranks=model.reference_ranks())
    ef_state = ef_int8_init(params) if grad_compress == "ef8" else {}
    groups = [[n for n in names if n in params] for names in model.reference_groups()]
    groups = [names for names in groups if names]

    def train_step(batch: dict, schedule=None) -> dict:
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
        if grad_compress == "ef8":
            ef_int8_compress(grads, ef_state, groups)
        _, _, stats = optimizer.update(grads, opt_state, params)  # in place: opt_state is the same dict
        for p in params.values():
            p.grad = None  # the gradients' memory is free until the next backward
        metrics = {"loss": loss_sum, **stats}
        if collect_routing:
            metrics["moe_stats"] = aux_sum
        return metrics

    state = {"params": params, "opt": opt_state, "ef": ef_state}
    if controller is None:
        train_step.state = state
        return train_step

    def train_step_device(batch: dict, ctrl_state) -> dict:
        metrics = train_step(batch, controller.table_of(ctrl_state))
        aux = metrics.pop("moe_stats")
        metrics["device_step"] = controller.step_device(ctrl_state, aux["routing"], aux["dropped"])
        return metrics

    train_step_device.state = state
    return train_step_device
