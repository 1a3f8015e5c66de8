"""AdamW with fp32 moments, global-norm clipping and a warmup+cosine
schedule (counterpart of ``repro.training.optimizer``).

The rounding points are the reference's: moments, bias corrections and
the update ``delta`` are fp32; the parameter moves by ``(lr * delta)``
cast to its own type. The update is functional: it returns a new state
and leaves the old one as it was.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


#: TrainState is a plain dict: {"params", "m", "v", "step"}; m and v are
#: fp32 trees shaped like params, step an int32 scalar on their device.
TrainState = Dict[str, object]


def adamw_init(params: Tree) -> TrainState:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
    device = tree_leaves(params)[0].device
    return {"params": params, "m": tree_map(zeros32, params),
            "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def train_state_axes(param_axes: Tree) -> Tree:
    """Logical axes for the whole TrainState (m/v mirror params)."""
    return {"params": param_axes, "m": param_axes, "v": param_axes,
            "step": ()}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step``: linear warmup, then cosine down to
    ``min_lr_ratio * lr`` at ``total_steps``, constant after."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree)])))


def adamw_update(state: TrainState, grads: Tree, cfg: AdamWConfig
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new state, {"lr", "grad_norm"})."""
    with torch.no_grad():
        step = state["step"] + 1
        lr = schedule(cfg, step)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
        b2c = 1.0 - cfg.b2 ** step.to(torch.float32)

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m2 = cfg.b1 * m + (1 - cfg.b1) * g
            v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
            delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps) \
                + cfg.weight_decay * p.to(torch.float32)
            return p - (lr * delta).to(p.dtype), m2, v2

        out = tree_map(upd, state["params"], grads, state["m"], state["v"])
        part = lambda i: tree_map(lambda t: t[i], out)
        # tree_map recurses into dicts and lists only, so the 3-tuples
        # are leaves
        new_state = {"params": part(0), "m": part(1), "v": part(2),
                     "step": step}
    return new_state, {"lr": lr, "grad_norm": gnorm}
