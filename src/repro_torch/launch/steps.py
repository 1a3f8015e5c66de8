"""Step builders (counterpart of ``repro.launch.steps``): (arch config,
shape, mesh) -> a train step over DTensor state.

A builder assembles meta-device inputs and Shardings from the
logical-axis rules without allocating anything, and returns them with
the step: the state and the batch are placed by those Shardings
(``StepBundle.place``), the step runs the model under
``activation_sharding``, and its new state is placed as the old one. Torch has nothing to lower, so the bundle holds
the step itself where the reference holds ``jax.jit(...).lower(...)``.

Inside the step, the plain tensors the model makes on its device
(positions, masks, RoPE tables, loss accumulators) meet DTensors. They
are the same on every rank, and the step treats every one of them as
replicated (``implicit_replication``), one rule for all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.shapes import Shape
from repro_torch.distributed.sharding import (FSDP_RULES, ShardingRules,
                                              activation_sharding,
                                              distribute_tree,
                                              tree_shardings)
from repro_torch.models.model import Model, ModelConfig
from repro_torch.models.transformer import tree_map
from repro_torch.training.data import batch_axes_for, batch_specs
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            train_state_axes)
from repro_torch.training.train_step import make_train_step

Tree = Any


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """Everything a driver needs for one (arch x shape x mesh)."""
    kind: str
    step: Callable
    in_specs: Tuple              # meta-device trees
    in_shardings: Tuple          # Sharding trees of the same structure
    model: Model

    def place(self, *trees: Tree) -> Tuple[Tree, ...]:
        """Full trees (the step's inputs, in order), each placed on the
        mesh by its Shardings; every rank passes the same trees."""
        return tuple(distribute_tree(t, s)
                     for t, s in zip(trees, self.in_shardings))


def _abstract_state(model: Model):
    specs, axes = model.abstract_params()
    return adamw_init(specs), train_state_axes(axes)


def build_train_step(cfg: ModelConfig, shape: Shape, mesh, *,
                     rules: ShardingRules = FSDP_RULES,
                     opt_cfg: Optional[AdamWConfig] = None,
                     microbatches: int = 1,
                     donate: bool = True) -> StepBundle:
    """The train step of ``cfg`` at ``shape`` on ``mesh``: the model lives
    on the mesh's device type. ``donate`` is the reference's; torch frees
    the old state when the caller drops it, so it changes nothing here."""
    model = Model(cfg, device=mesh.device_type)
    opt_cfg = opt_cfg or AdamWConfig()
    state_specs, state_axes = _abstract_state(model)
    state_sh = tree_shardings(mesh, rules, state_axes, state_specs)

    b_specs = batch_specs(cfg, shape, kind="train")
    b_sh = tree_shardings(mesh, rules, batch_axes_for(b_specs), b_specs)

    train = make_train_step(model, opt_cfg, microbatches=microbatches)

    def step(state, batch):
        with activation_sharding(mesh, rules), implicit_replication():
            new, metrics = train(state, batch)
            # the reference's out_shardings: the new state is placed as
            # the old one was
            return tree_map(lambda t, sh: t.redistribute(sh.mesh,
                                                         sh.placements),
                            new, state_sh), metrics

    return StepBundle("train", step, (state_specs, b_specs),
                      (state_sh, b_sh), model)


def build_step(cfg: ModelConfig, shape: Shape, mesh, **kw) -> StepBundle:
    if shape.kind != "train":
        raise NotImplementedError(
            f"the sharded {shape.kind} step is not ported yet: it needs the "
            f"flash and SSD kernels to take DTensors (ROADMAP.md A.2)")
    return build_train_step(cfg, shape, mesh, **kw)
