"""The train step of the port (the JAX package's ``repro/train/train_step.py``):
micro-batched gradient accumulation, the gradients kept in ``grad_dtype``,
global-norm clipping, the optimizer update.

    model = Model(cfg)                     # on "cuda"
    opt = get_optimizer(cfg.optimizer)
    step = make_train_step(model, opt, cosine_with_warmup(3e-4, 100, steps))
    state = init_train_state(model, opt)
    state, metrics = step(state, pipeline.batch_at(0))

The state is the JAX package's ``{"params", "opt", "step"}``.  Its
"params" is ``models.convert.jax_tree(model)``: the model's own parameters
seen as the JAX package's leaves, which the update writes in place (no
second copy of the weights is held); "opt" is the optimizer's state over
those leaves and "step" an int32 scalar on the model's device.

* grad accumulation (``cfg.grad_accum``): the batch is cut into that many
  micro-batches along axis 0, one forward and backward each;
* gradient compression (``grad_dtype="bfloat16"``): each micro-batch's
  gradients are cast to bf16 and summed in it, as the JAX package keeps
  them for its cross-replica reduction.

A step whose loss is not finite changes nothing (the update is in place;
the JAX package's trainer drops such a step's new state).
``abstract_train_state`` is the dry-run's shape-only state: the same tree
over a model on the ``meta`` device, nothing allocated.
"""
from __future__ import annotations

import torch

from repro_torch.models.convert import Leaf, jax_tree
from repro_torch.models.model import Model
from repro_torch.optim.optimizer import Optimizer, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor

_GRAD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _micro(x, i: int, ga: int):
    b = x.shape[0] // ga
    return x[i * b:(i + 1) * b]


def make_train_step(
    model: Model,
    optimizer: Optimizer,
    lr_schedule,
    *,
    grad_dtype: str = "float32",
    clip_norm: float = 1.0,
):
    ga = max(model.cfg.grad_accum, 1)
    gdt = _GRAD_DTYPES[grad_dtype]
    params = list(model.parameters())

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        leaves, opt_state, step = state["params"], state["opt"], state["step"]
        gsum, lsum = None, 0.0
        for i in range(ga):
            micro = {k: _micro(v, i, ga) for k, v in batch.items()}
            loss, _ = model.loss(micro)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p, dtype=gdt) if g is None else g.to(gdt)
                     for p, g in zip(params, grads)]
            gsum = grads if gsum is None else [a + g for a, g in zip(gsum, grads)]
            lsum = lsum + loss.detach()
        by_param = {p: g / ga if ga > 1 else g for p, g in zip(params, gsum)}
        del gsum, grads  # one copy of the gradients at a time
        loss = lsum / ga
        grads, gnorm = clip_by_global_norm(tree_map(lambda lf: lf.value(by_param), leaves),
                                           clip_norm)
        del by_param
        lr = lr_schedule(step)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        # on the meta device (the dry-run) there is no value to test
        if loss.device.type != "meta" and not bool(torch.isfinite(loss)):
            return state, metrics
        values = tree_map(Leaf.value, leaves)
        new_values, new_opt = optimizer.update(grads, opt_state, values, lr)
        for leaf, v in zip(tree_leaves(leaves), tree_leaves(new_values)):
            leaf.assign_(v)
        return {"params": leaves, "opt": new_opt, "step": step + 1}, metrics

    return train_step


def init_train_state(model: Model, optimizer: Optimizer) -> dict:
    """``{"params", "opt", "step"}`` over ``model``'s current weights (the
    JAX package's takes an rng for ``Model.init``; the port's model holds
    its seeded weights already)."""
    leaves = jax_tree(model)
    return {"params": leaves, "opt": optimizer.init(leaves),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def abstract_train_state(model: Model, optimizer: Optimizer) -> dict:
    """The train state of ``model``'s configuration on the ``meta`` device:
    the leaves' shapes and dtypes of ``init_train_state``, no storage.  The
    port's init draws from a torch generator, and on ``meta`` there is
    nothing to draw, so only the shapes are made (``model`` may be any
    device's; a meta twin of its configuration is built)."""
    if model.device.type != "meta":
        model = Model(model.cfg, device="meta", seed=None)
    return init_train_state(model, optimizer)


def load_state(state: dict, restored: dict) -> dict:
    """``state`` holding ``restored`` (a checkpoint's tree of CPU tensors):
    the parameters written into the model in place, the other leaves moved
    to the device of the leaves they replace."""
    def put(cur, new):
        if isinstance(cur, Leaf):
            cur.assign_(new)
            return cur
        return torch.as_tensor(new).to(cur.device)

    return tree_map(put, state, restored)
