"""Train-step factory: microbatched gradient accumulation + AdamW
(counterpart of ``repro.training.train_step``).

``make_train_step(model, opt_cfg, microbatches=m)`` returns a
``(state, batch) -> (state, metrics)`` function that leaves its inputs
as they were. With m > 1 the batch is split along its first axis and
the gradients are summed in fp32 over the microbatches, then divided by
m, as the reference's ``lax.scan`` does: the AARC autotuner's memory
knob (activations scale with batch / m, arithmetic does not change).
``cfg.remat`` is the other one.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import NO_BACKWARD
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWConfig, adamw_update

Tree = Dict[str, object]


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int):
    b = batch["tokens"].shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    return [{k: v.reshape(m, b // m, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(m)]


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_transform: Optional[Callable[[Tree], Tree]] = None
                    ) -> Callable:
    """Returns train_step(state, batch) -> (new state, metrics).

    Metrics: ``loss``, ``lr``, ``grad_norm``, and ``ce`` when m == 1, as
    in the reference. A config that routes a layer through a kernel
    raises: no kernel has a backward pass.
    """
    cfg = model.cfg
    if cfg.attn_impl == "kernel" or cfg.use_ssm_kernel:
        raise ValueError(f"make_train_step: {NO_BACKWARD}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def grads_of(params: Tree, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        with torch.enable_grad():
            loss, metrics = model.loss(tree_map(lambda _: next(it), params),
                                       batch)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, list(grads)

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            g_sum, loss = None, torch.zeros((), dtype=torch.float32,
                                            device=model.device)
            for mb in _split_microbatches(batch, microbatches):
                l, _, g = grads_of(params, mb)
                if g_sum is None:
                    g_sum = [x.to(torch.float32) for x in g]
                else:
                    for acc, x in zip(g_sum, g):
                        acc.add_(x)
                loss = loss + l
            grads = [g / microbatches for g in g_sum]
            loss = loss / microbatches
            metrics = {"loss": loss}
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if grad_transform is not None:
            grads = grad_transform(grads)
        new_state, opt_metrics = adamw_update(state, grads, opt_cfg)
        out = {"loss": loss, **opt_metrics}
        if "ce" in metrics:
            out["ce"] = metrics["ce"].detach()
        return new_state, out

    return train_step
