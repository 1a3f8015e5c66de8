"""Mixture-of-Experts FFN with capacity-based gather dispatch (counterpart
of ``repro.models.moe``).

Expert-major gather, as in the reference: every expert takes its
top-``capacity`` tokens of the routing matrix, runs its FFN on a dense
(experts, capacity, d) block and scatter-adds the results back to their
tokens, weighted by the gate. Shared experts, added through a sigmoid
gate (Qwen2-MoE) or ungated (Granite 4.0-H, ``shared_gated=False``), and
top-k renormalisation (Granite) are supported; ``apply_moe`` also returns the
Switch-style load-balance loss.

Three choices keep the port on the reference's results and make it
repeat itself bit for bit on the card:

  * every top-k is a stable descending sort, so that among equal values
    the lower index comes first, as with ``lax.top_k`` (``torch.topk``
    promises no order). The routing matrix is mostly zeros, and two equal
    prompts give equal rows, so the capacity cut often falls among ties;
  * no sum of the dispatch uses atomics, whose order changes from run
    to run (``index_add_`` on CUDA, ``index_put(accumulate=True)`` in
    fp32 on a multi-threaded CPU, and the backward of every gather). The
    sum back to tokens and the gather's backward are one gather over a
    (token, top-k) map of rows, summed in the token's top-k order
    (``_Gather``, ``_Combine``);
  * the router and shared-expert products are 2-D matmuls (``aten.mm``),
    which ``remat="dots"`` saves, and the expert products are batched
    (``aten.bmm``), which it recomputes, as the reference's
    ``checkpoint_dots_with_no_batch_dims`` does.

A sequence padded at its end to a fixed length (a batch-1 prefill run at
a bucket's length, so that one captured graph serves every prompt that
pads to it) passes its real tokens (:class:`RealTokens`): the pads'
routing is zeroed, each expert's top-k runs at the padded length's
capacity, and its rows past the capacity of the real count are dropped
(gate 0, named by no token). The top-k is stable and the pads, routed
0, sit above every real token, so the rows kept are the (token, expert)
pairs that the call on the real tokens alone takes.

While tracing is on (:mod:`repro_torch.tracing`) the dispatch counts, per
phase ("decode" for one token a sequence, "prefill" otherwise), the
capacity rows it runs, the (token, expert) pairs the router chose and the
pairs the experts took (:func:`read_moe_stats`). The counts known on the
host are added at once; the pairs taken are kept as the step's own row
map and summed only when read, so counting adds no kernel launch and no
wait to the step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.layers import dense_init, normal

Params = Dict[str, torch.Tensor]

#: the score given to a padded (dead) expert before the softmax
DEAD_SCORE = -1e30


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int            # per-expert FFN width
    shared_ff: int = 0        # shared-expert FFN width (0 = none)
    #: the shared expert's output goes through a sigmoid gate of its own
    #: router (Qwen2-MoE); False adds it as it is (Granite 4.0-H)
    shared_gated: bool = True
    norm_topk: bool = False   # renormalize top-k gate weights
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    #: "global"  — expert-major top-k over all tokens,
    #: "grouped" — per-sequence capacity: routing, gather and scatter are
    #:             batched over the batch dim
    dispatch: str = "global"
    #: pad the expert dim to this count (0 = no padding); padded experts
    #: are masked out of the router and receive no tokens
    pad_to: int = 0

    @property
    def e_total(self) -> int:
        return max(self.pad_to, self.n_experts)


def make_moe_params(gen, d_model: int, cfg: MoEConfig, dtype,
                    device) -> Params:
    """The reference's leaves, shapes and dtypes: an fp32 router (d, e),
    expert weights (e, d, f) / (e, f, d) and the shared expert's."""
    e, f = cfg.e_total, cfg.expert_ff
    params = {
        "router": dense_init(gen, d_model, e, torch.float32, device),
        "gate": normal(gen, (e, d_model, f), dtype, d_model ** -0.5, device),
        "up": normal(gen, (e, d_model, f), dtype, d_model ** -0.5, device),
        "down": normal(gen, (e, f, d_model), dtype, f ** -0.5, device),
    }
    if cfg.shared_ff > 0:
        params.update({
            "shared_gate": dense_init(gen, d_model, cfg.shared_ff, dtype,
                                      device),
            "shared_up": dense_init(gen, d_model, cfg.shared_ff, dtype,
                                    device),
            "shared_down": dense_init(gen, cfg.shared_ff, d_model, dtype,
                                      device, scale=cfg.shared_ff ** -0.5),
        })
        if cfg.shared_gated:
            params["shared_router"] = dense_init(gen, d_model, 1, dtype,
                                                 device)
    return params


def moe_axes(cfg: MoEConfig) -> Dict[str, tuple]:
    """The logical axes of :func:`make_moe_params`' tree."""
    axes = {"router": ("embed", "expert"),
            "gate": ("expert", "embed", "mlp"),
            "up": ("expert", "embed", "mlp"),
            "down": ("expert", "mlp", "embed")}
    if cfg.shared_ff > 0:
        axes.update(shared_gate=("embed", "mlp"), shared_up=("embed", "mlp"),
                    shared_down=("mlp", "embed"))
        if cfg.shared_gated:
            axes["shared_router"] = ("embed", "null")
    return axes


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _routing(params: Params, xf: torch.Tensor, cfg: MoEConfig):
    """Router softmax + top-k. xf: (..., t, d) -> routing (..., t, e)."""
    scores = xf.float() @ params["router"]
    if cfg.e_total > cfg.n_experts:          # mask padded (dead) experts
        dead = torch.arange(cfg.e_total, device=xf.device) >= cfg.n_experts
        scores = scores.masked_fill(dead, DEAD_SCORE)
    probs = torch.softmax(scores, dim=-1)
    top_p, top_idx = _top_k(probs, cfg.top_k)
    if cfg.norm_topk:
        top_p = top_p / (top_p.sum(dim=-1, keepdim=True) + 1e-9)
    # each expert appears at most once among a token's top-k, so this
    # equals the reference's sum of one-hot rows exactly
    routing = torch.zeros_like(probs).scatter(-1, top_idx, top_p)
    return routing, probs, top_idx


#: the least capacity of each dispatch
FLOOR = {"global": 8, "grouped": 4}


def _capacity(n_tokens: int, cfg: MoEConfig, floor: int) -> int:
    cap = max(int(n_tokens * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts), floor)
    return min(cap, n_tokens)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """The rows each expert takes from ``n_tokens`` tokens (those of the
    call under global dispatch, of one sequence under grouped)."""
    return _capacity(n_tokens, cfg, FLOOR[cfg.dispatch])


class RealTokens(NamedTuple):
    """The real tokens of one sequence padded at its end: their count
    ``n`` and ``cap``, the :func:`capacity` at that count. Each is a (1,)
    int64 tensor on the device, so that a graph captured once serves
    every count."""

    n: torch.Tensor
    cap: torch.Tensor


def _expert_choice(routing: torch.Tensor, cap: int,
                   real: Optional[RealTokens]):
    """Each expert's top-``cap`` tokens of routing (..., t, e): (gate_ec,
    tok_ec (..., e, cap), the live rows (cap,) or None if all are). With
    ``real`` the routing of the pads (positions >= real.n) is zeroed
    first, and the rows at index >= real.cap are not live: their gate is
    0 and no token names them (:func:`_token_rows`)."""
    if real is None:
        return (*_top_k(routing.transpose(-1, -2), cap), None)
    pad = torch.arange(routing.shape[-2], device=routing.device) >= real.n
    routing = routing.masked_fill(pad[:, None], 0.0)
    gate_ec, tok_ec = _top_k(routing.transpose(-1, -2), cap)
    live = torch.arange(cap, device=routing.device) < real.cap
    return gate_ec.masked_fill(~live, 0.0), tok_ec, live


def _experts(params: Params, x_ec: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert on its own tokens: x_ec (..., e, c, d)."""
    h = torch.einsum("...ecd,edf->...ecf", x_ec, params["gate"])
    h = F.silu(h) * torch.einsum("...ecd,edf->...ecf", x_ec, params["up"])
    return torch.einsum("...ecf,efd->...ecd", h, params["down"])


def _token_rows(tok: torch.Tensor, top_idx: torch.Tensor, n_tokens: int,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of the dispatched block, numbered as ``tok.reshape(-1)``
    (tok: (..., e, c), the token of each row), that hold each token's
    top-k choices: (n_tokens, k), -1 where the expert dropped the token
    (or took it in a row that ``live`` (c,) marks dead). An expert takes a
    token at most once, so each (token, expert) pair names at most one
    row."""
    expert = torch.arange(tok.shape[-2], device=tok.device)[:, None]
    rows = torch.full((n_tokens, tok.shape[-2]), -1, dtype=torch.long,
                      device=tok.device)
    row = torch.arange(tok.numel(), device=tok.device)
    if live is not None:
        row = torch.where(live.expand(tok.shape).reshape(-1), row, -1)
    rows[tok.reshape(-1), expert.expand(tok.shape).reshape(-1)] = row
    return rows.gather(1, top_idx)


def _sum_rows(rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """out[t] = the sum over j of rows[src[t, j]] where src >= 0, in j
    order: (R, d), (T, k) -> (T, d)."""
    picked = rows[src.clamp(min=0)]                              # (T, k, d)
    return torch.where(src[..., None] >= 0, picked, 0).sum(dim=1)


class _Gather(torch.autograd.Function):
    """rows = x[tok]. Backward sums each token's rows through ``src``: a
    row outside its token's top-k (an expert filling its capacity with a
    token it was not routed) carries gate 0, so its gradient is 0."""

    @staticmethod
    def forward(ctx, x, tok, src):
        ctx.save_for_backward(src)
        return x[tok]

    @staticmethod
    def backward(ctx, grad):
        (src,) = ctx.saved_tensors
        return _sum_rows(grad, src), None, None


class _Combine(torch.autograd.Function):
    """out[t] = the sum of the gated rows of token t's top-k choices; the
    other rows of t carry gate 0. Backward is the gather grad[tok]."""

    @staticmethod
    def forward(ctx, rows, tok, src):
        ctx.save_for_backward(tok)
        return _sum_rows(rows, src)

    @staticmethod
    def backward(ctx, grad):
        (tok,) = ctx.saved_tensors
        return grad[tok], None, None


# -- dispatch counters ------------------------------------------------------

_STAT_KEYS = ("capacity_rows", "routed_pairs", "taken_pairs")
_stats: Dict[str, Dict[str, int]] = {}
#: each phase's row maps (``_token_rows``) not yet summed
_kept: Dict[str, List[torch.Tensor]] = {}


def _count(phase: str, tok_ec: torch.Tensor, top_idx: torch.Tensor,
           src: torch.Tensor) -> None:
    st = _stats.setdefault(phase, dict.fromkeys(_STAT_KEYS, 0))
    st["capacity_rows"] += tok_ec.numel()
    st["routed_pairs"] += top_idx.numel()
    _kept.setdefault(phase, []).append(src)


def read_moe_stats() -> Dict[str, Dict[str, int]]:
    """Per phase, the capacity rows run, the routed (token, expert) pairs
    and the pairs taken since the last :func:`reset_moe_stats`, as Python
    ints. Sums the kept row maps (a wait for the device) and drops them."""
    for phase, kept in _kept.items():
        if kept:
            taken = sum((src >= 0).sum() for src in kept)
            _stats[phase]["taken_pairs"] += int(taken)
            kept.clear()
    return {phase: dict(st) for phase, st in _stats.items()}


def reset_moe_stats() -> None:
    _stats.clear()
    _kept.clear()


def _dispatch(params: Params, xf: torch.Tensor, top_idx: torch.Tensor,
              gate_ec: torch.Tensor, tok_ec: torch.Tensor,
              phase: Optional[str] = None,
              live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather each expert's tokens (tok_ec (..., e, c), ids into xf's
    rows), run the experts, weight by the gate and sum back to tokens;
    the rows ``live`` marks dead reach no token. With a ``phase``, the
    dispatch is counted under it."""
    tok = tok_ec.reshape(-1)
    src = _token_rows(tok_ec, top_idx, xf.shape[0], live)
    if phase is not None:
        _count(phase, tok_ec, top_idx, src)
    x_ec = _Gather.apply(xf, tok, src).reshape(*tok_ec.shape, -1)
    y_ec = _experts(params, x_ec)
    y_ec = y_ec * gate_ec[..., None].to(y_ec.dtype)
    return _Combine.apply(y_ec.reshape(tok.numel(), -1), tok, src)


def _dispatch_global(params: Params, xf: torch.Tensor, cfg: MoEConfig,
                     phase: Optional[str] = None,
                     real: Optional[RealTokens] = None):
    """Expert-major top-k over the whole token set. Returns (out, probs,
    top_idx, tok_ec), tok_ec (e, c) the tokens each expert took."""
    routing, probs, top_idx = _routing(params, xf, cfg)
    gate_ec, tok_ec, live = _expert_choice(routing,
                                           capacity(xf.shape[0], cfg), real)
    return _dispatch(params, xf, top_idx, gate_ec, tok_ec, phase, live), \
        probs, top_idx, tok_ec


def _dispatch_grouped(params: Params, x: torch.Tensor, cfg: MoEConfig,
                      phase: Optional[str] = None,
                      real: Optional[RealTokens] = None):
    """Per-sequence capacity: routing and the capacity top-k are batched
    over the batch dim. Returns (out (b*s, d), probs, top_idx, tok_ec
    (b, e, c)). The gather takes the flattened (b*e*c) index set and never
    materialises more than (b, e*c, d)."""
    b, s, d = x.shape
    routing, probs, top_idx = _routing(params, x, cfg)            # (b,s,e)
    gate_ec, tok_ec, live = _expert_choice(routing, capacity(s, cfg), real)
    offset = torch.arange(0, b * s, s, device=x.device)[:, None, None]
    top_idx = top_idx.reshape(b * s, -1)
    out = _dispatch(params, x.reshape(b * s, d), top_idx, gate_ec,
                    tok_ec + offset, phase, live)
    return out, probs.reshape(b * s, -1), top_idx, tok_ec


def apply_moe(params: Params, x: torch.Tensor, cfg: MoEConfig,
              real: Optional[RealTokens] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (batch, seq, d) -> (output, aux_loss). With ``real``, x is one
    sequence padded at its end, and the experts take from its real tokens
    what the call on them alone takes; the pads' output is the shared
    expert's alone, and the aux loss counts the pads too."""
    b, s, d = x.shape
    if real is not None and b != 1:
        raise ValueError(f"real tokens describe one sequence, got a batch "
                         f"of {b}")
    xf = x.reshape(b * s, d)
    phase = ("decode" if s == 1 else "prefill") if tracing.enabled() \
        else None
    if cfg.dispatch == "grouped":
        out, probs, top_idx, _ = _dispatch_grouped(params, x, cfg, phase,
                                                   real)
    elif cfg.dispatch == "global":
        out, probs, top_idx, _ = _dispatch_global(params, xf, cfg, phase,
                                                  real)
    else:
        raise ValueError(f"unknown MoE dispatch {cfg.dispatch!r}")

    if cfg.shared_ff > 0:
        with tracing.span("rt.shared"):
            sh = (F.silu(xf @ params["shared_gate"])
                  * (xf @ params["shared_up"])) @ params["shared_down"]
            if cfg.shared_gated:
                sh = torch.sigmoid(xf @ params["shared_router"]) * sh
            out = out + sh

    # Switch-style load-balance auxiliary loss
    frac_tokens = F.one_hot(top_idx, cfg.e_total).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=0)
    aux = cfg.n_experts * (frac_tokens * frac_probs).sum() * cfg.aux_coef
    return out.reshape(b, s, d).to(x.dtype), aux
