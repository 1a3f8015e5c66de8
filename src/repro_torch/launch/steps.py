"""Step builders (counterpart of ``repro.launch.steps``): (arch config,
shape, mesh) -> a train, prefill or serve (one-token decode) step over
DTensor params, state and caches.

A builder assembles meta-device inputs and Shardings from the
logical-axis rules without allocating anything, and returns them with
the step: the inputs are placed by those Shardings
(``StepBundle.place``), the step runs the model under
``activation_sharding``, and the train step's new state and the serve
step's new cache are placed as the old ones (the reference's
``out_shardings``). Torch has nothing to lower, so the bundle holds the
step itself where the reference holds ``jax.jit(...).lower(...)``.

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
from repro_torch.tree import tree_map
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


def _placed_as(tree: Tree, shardings: Tree) -> Tree:
    return tree_map(lambda t, sh: t.redistribute(sh.mesh, sh.placements),
                    tree, shardings)


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
            return _placed_as(new, state_sh), metrics

    return StepBundle("train", step, (state_specs, b_specs),
                      (state_sh, b_sh), model)


def build_prefill_step(cfg: ModelConfig, shape: Shape, mesh, *,
                       rules: ShardingRules = FSDP_RULES) -> StepBundle:
    """The prefill of ``cfg`` over ``shape``'s batch into a cache
    ``shape.seq_len`` deep: ``step(params, batch) -> (last-position
    logits, cache)``. As in the reference, the cache's placement is left
    to the step (its sequence whole, batch and heads as the attention
    left them); the serve step places it by the cache's rules."""
    model = Model(cfg, device=mesh.device_type)
    p_specs, p_axes = model.abstract_params()
    p_sh = tree_shardings(mesh, rules, p_axes, p_specs)

    b_specs = batch_specs(cfg, shape, kind="prefill")
    b_sh = tree_shardings(mesh, rules, batch_axes_for(b_specs), b_specs)

    def step(params, batch):
        with activation_sharding(mesh, rules), implicit_replication():
            return model.prefill(params, batch, max_len=shape.seq_len)

    return StepBundle("prefill", step, (p_specs, b_specs), (p_sh, b_sh),
                      model)


def build_serve_step(cfg: ModelConfig, shape: Shape, mesh, *,
                     rules: ShardingRules = FSDP_RULES,
                     donate: bool = True) -> StepBundle:
    """One-token decode against a ``shape.seq_len``-deep cache (decode
    shapes): ``step(params, cache, tokens) -> (logits, cache)``, the new
    cache placed as the old one. The cache's tensors are updated in place
    (each rank its own shards), so ``donate`` changes nothing here."""
    model = Model(cfg, device=mesh.device_type)
    p_specs, p_axes = model.abstract_params()
    p_sh = tree_shardings(mesh, rules, p_axes, p_specs)

    c_specs, c_axes = model.abstract_cache(shape.global_batch, shape.seq_len)
    c_sh = tree_shardings(mesh, rules, c_axes, c_specs)

    t_specs = batch_specs(cfg, shape, kind="decode")
    t_sh = tree_shardings(mesh, rules, {"tokens": ("batch", None)}, t_specs)

    def step(params, cache, tokens):
        with activation_sharding(mesh, rules), implicit_replication():
            logits, new = model.decode_step(params, cache, tokens)
            return logits, _placed_as(new, c_sh)

    return StepBundle("decode", step, (p_specs, c_specs, t_specs["tokens"]),
                      (p_sh, c_sh, t_sh["tokens"]), model)


def build_step(cfg: ModelConfig, shape: Shape, mesh, **kw) -> StepBundle:
    builders = {"train": build_train_step, "prefill": build_prefill_step,
                "decode": build_serve_step}
    if shape.kind not in builders:
        raise ValueError(f"unknown step kind {shape.kind!r}; one of "
                         f"{tuple(builders)}")
    return builders[shape.kind](cfg, shape, mesh, **kw)
