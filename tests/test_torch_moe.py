"""The port's MoE family against the JAX package's: the MoE layer (routing,
both dispatches, shared experts, top-k renormalisation, padded experts,
ties at the capacity cut), and reduced qwen2-moe / granite-moe models
(prefill and decode with drops, engine tokens, loss and gradients, remat,
checkpoints, active parameters), on weights made in JAX and bridged."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as ref_registry
from repro.models import moe as ref_moe
from repro.models.model import Model as RefModel
from repro.serving import RequestQueue as RefQueue
from repro.serving import ServeEngine as RefEngine
from repro.training import checkpoint as ref_ckpt
from repro.training import data as ref_data
from repro.training.optimizer import adamw_init as ref_adamw_init
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.serving import RequestQueue, ServeEngine
from repro_torch.launch import train as launch_train
from repro_torch.training.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.optimizer import adamw_init

#: MoE layer outputs and aux loss in fp32 (the slice's stated tolerance)
MOE_TOL = dict(atol=1e-5, rtol=1e-4)
#: prefill / decode (tests/test_serving.py)
DEC_TOL = dict(atol=2e-3, rtol=2e-2)
#: loss and gradients (tests/test_training.py)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")


# --------------------------------------------------------------------------
# the MoE layer
# --------------------------------------------------------------------------

def _layer(variant="shared", **overrides):
    """(port cfg, reference cfg, port params, reference params) of one
    MoE layer at d = 64, weights made in JAX."""
    kw = dict(n_experts=8, top_k=2, expert_ff=32)
    kw.update({"shared": dict(shared_ff=64), "norm_topk": dict(norm_topk=True),
               "pad_to": dict(n_experts=6, pad_to=8)}[variant])
    kw.update(overrides)
    ref_cfg = ref_moe.MoEConfig(**kw)
    ref_params, _ = ref_moe.make_moe_params(jax.random.key(0), 64, ref_cfg,
                                            jnp.float32)
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return moe.MoEConfig(**kw), ref_cfg, params, ref_params


def _x(b=2, s=32, d=64, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _ref_plan(ref_params, x, cfg):
    """The reference's top_idx (t, k) and tok_ec, recomputed from its own
    ``_routing`` and ``lax.top_k`` as its dispatch functions do."""
    b, s, d = x.shape
    if cfg.dispatch == "grouped":
        routing, _, top_idx = ref_moe._routing(ref_params, jnp.asarray(x),
                                               cfg)
        cap = min(max(int(s * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts), 4), s)
        _, tok_ec = jax.lax.top_k(routing.transpose(0, 2, 1), cap)
        top_idx = top_idx.reshape(b * s, -1)
    else:
        routing, _, top_idx = ref_moe._routing(
            ref_params, jnp.asarray(x.reshape(b * s, d)), cfg)
        cap = min(max(int(b * s * cfg.top_k * cfg.capacity_factor
                          / cfg.n_experts), 8), b * s)
        _, tok_ec = jax.lax.top_k(routing.T, cap)
    return np.asarray(routing), np.asarray(top_idx), np.asarray(tok_ec)


def _port_plan(params, x, cfg):
    xt = torch.from_numpy(x)
    if cfg.dispatch == "grouped":
        _, _, top_idx, tok_ec = moe._dispatch_grouped(params, xt, cfg)
    else:
        _, _, top_idx, tok_ec = moe._dispatch_global(
            params, xt.reshape(-1, x.shape[-1]), cfg)
    return top_idx.numpy(), tok_ec.numpy()


def test_make_moe_params_has_the_reference_layout():
    """Leaf names, shapes and dtypes as the reference's, in fp32 and bf16
    (the router stays fp32), with and without shared experts and padding."""
    for variant in ("shared", "norm_topk", "pad_to"):
        cfg, ref_cfg, _, _ = _layer(variant)
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            gen = torch.Generator().manual_seed(0)
            got = moe.make_moe_params(gen, 64, cfg, dtype, "cpu")
            want, _ = ref_moe.make_moe_params(jax.random.key(0), 64, ref_cfg,
                                              jdtype)
            assert sorted(got) == sorted(want)
            for k, w in want.items():
                assert tuple(got[k].shape) == w.shape, k
                assert str(got[k].dtype)[6:] == str(w.dtype), k


@pytest.mark.parametrize("variant", ["shared", "norm_topk", "pad_to"])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_apply_moe_matches_reference(dispatch, capacity_factor, variant):
    """Output and aux at the fp32 tolerance; the routing choices (top_idx)
    and the tokens each expert takes (tok_ec) exactly. At the default
    capacity factor some routed (token, expert) pairs are dropped."""
    cfg, ref_cfg, params, ref_params = _layer(
        variant, dispatch=dispatch, capacity_factor=capacity_factor)
    x = _x()
    want, want_aux = ref_moe.apply_moe(ref_params, jnp.asarray(x), ref_cfg)
    got, aux = moe.apply_moe(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)
    routing, ref_top, ref_tok = _ref_plan(ref_params, x, ref_cfg)
    top_idx, tok_ec = _port_plan(params, x, cfg)
    np.testing.assert_array_equal(top_idx, ref_top)
    np.testing.assert_array_equal(tok_ec, ref_tok)
    routed = int((routing > 0).sum())
    if dispatch == "global":
        kept = sum(int((routing[tok_ec[e], e] > 0).sum())
                   for e in range(cfg.e_total))
    else:
        kept = sum(int((routing[i][tok_ec[i, e], e] > 0).sum())
                   for i in range(x.shape[0]) for e in range(cfg.e_total))
    assert (kept < routed) == (capacity_factor == 1.25), (kept, routed)


@pytest.mark.parametrize("dispatch,case", [
    ("global", "one_row"), ("grouped", "one_row"),
    ("global", "two_equal_sequences")])
def test_capacity_ties_break_as_the_reference(dispatch, case):
    """Equal routing values at the capacity cut: the lower token index is
    taken first, as lax.top_k takes it. ``one_row`` repeats one row for
    every token; ``two_equal_sequences`` gives global dispatch a batch of
    two equal sequences of 24 tokens, so that it sees every value twice,
    at an odd capacity (15), which cuts between the two of a pair."""
    cfg, ref_cfg, params, ref_params = _layer("shared", dispatch=dispatch)
    if case == "one_row":
        x = np.broadcast_to(_x(1, 1), (2, 32, 64)).copy()
    else:
        x = np.concatenate([_x(1, 24)] * 2)
    routing, ref_top, ref_tok = _ref_plan(ref_params, x, ref_cfg)
    top_idx, tok_ec = _port_plan(params, x, cfg)
    np.testing.assert_array_equal(top_idx, ref_top)
    np.testing.assert_array_equal(tok_ec, ref_tok)
    # the cut does fall among equal nonzero values: some expert keeps a
    # token and leaves out another of the same routing value
    r = routing if dispatch == "global" else routing[0]
    tok = tok_ec if dispatch == "global" else tok_ec[0]
    split = [e for e in range(cfg.e_total)
             if r[tok[e, -1], e] > 0 and
             ((r[:, e] == r[tok[e, -1], e]).sum() >
              (r[tok[e], e] == r[tok[e, -1], e]).sum())]
    assert split, "no tie at the capacity cut"
    want, _ = ref_moe.apply_moe(ref_params, jnp.asarray(x), ref_cfg)
    got, _ = moe.apply_moe(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


def _port_layer(cfg, d=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return moe.make_moe_params(gen, d, cfg, torch.float32, "cpu")


def test_grouped_dispatch_matches_global_dropfree():
    """tests/test_perf_features.py's first MoE test, on the port."""
    cfg_g = moe.MoEConfig(n_experts=8, top_k=2, expert_ff=32, shared_ff=64,
                          capacity_factor=8.0, dispatch="global")
    cfg_l = dataclasses.replace(cfg_g, dispatch="grouped")
    params = _port_layer(cfg_g)
    x = torch.from_numpy(_x(2, 16))
    yg, ag = moe.apply_moe(params, x, cfg_g)
    yl, al = moe.apply_moe(params, x, cfg_l)
    np.testing.assert_allclose(yg.numpy(), yl.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(ag), float(al), atol=1e-6)


def test_expert_padding_is_bit_exact():
    """Padded experts (masked out of the router) never change outputs."""
    cfg_p = moe.MoEConfig(n_experts=6, top_k=2, expert_ff=32,
                          capacity_factor=8.0, pad_to=8)
    params_p = _port_layer(cfg_p)
    x = torch.from_numpy(_x(2, 16))
    yp, _ = moe.apply_moe(params_p, x, cfg_p)
    cfg_u = dataclasses.replace(cfg_p, pad_to=0)
    params_u = {k: (v[:, :6] if k == "router" else v[:6])
                for k, v in params_p.items()}
    yu, _ = moe.apply_moe(params_u, x, cfg_u)
    np.testing.assert_allclose(yp.numpy(), yu.numpy(), atol=1e-6)


def test_padded_experts_receive_no_tokens():
    cfg = moe.MoEConfig(n_experts=6, top_k=2, expert_ff=32,
                        capacity_factor=8.0, pad_to=8)
    params = _port_layer(cfg)
    x = torch.from_numpy(_x(2, 16)).reshape(-1, 64)
    routing, _, top_idx = moe._routing(params, x, cfg)
    assert int(top_idx.max()) < 6, "router selected a dead expert"
    assert float(routing[:, 6:].sum()) == 0.0


def test_unknown_dispatch_raises():
    cfg = moe.MoEConfig(n_experts=8, top_k=2, expert_ff=32, dispatch="ragged")
    with pytest.raises(ValueError, match="dispatch"):
        moe.apply_moe(_port_layer(cfg), torch.from_numpy(_x(1, 4)), cfg)


# --------------------------------------------------------------------------
# a sequence padded at its end, with its real-token count
# --------------------------------------------------------------------------

def _plan_of(monkeypatch, params, x, cfg, real=None):
    """(out, top_idx (T, k), gate_ec (e, c), tok_ec (e, c), src (T, k)) of
    one batch-1 call of ``apply_moe``: the arguments its dispatch ran
    with, and the row map they give."""
    seen = {}
    inner = moe._dispatch

    def spy(params, xf, top_idx, gate_ec, tok_ec, phase=None, live=None):
        seen.update(top_idx=top_idx, gate=gate_ec.reshape(gate_ec.shape[-2:]),
                    tok=tok_ec.reshape(tok_ec.shape[-2:]),
                    src=moe._token_rows(tok_ec, top_idx, xf.shape[0], live))
        return inner(params, xf, top_idx, gate_ec, tok_ec, phase, live)

    monkeypatch.setattr(moe, "_dispatch", spy)
    out, _ = moe.apply_moe(params, x, cfg, real=real)
    monkeypatch.undo()
    return out[0], seen["top_idx"], seen["gate"], seen["tok"], seen["src"]


def _taken(top_idx, src, cap, s):
    """{(token, expert): its rank among the expert's rows} of the pairs
    the real tokens (< s) had taken."""
    return {(t, int(top_idx[t, j])): int(src[t, j]) % cap
            for t in range(s) for j in range(top_idx.shape[1])
            if src[t, j] >= 0}


def _real(n, cfg):
    return moe.RealTokens(torch.tensor([n]),
                          torch.tensor([moe.capacity(n, cfg)]))


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("case,s,width", [
    ("ragged", 21, 32), ("ties", 24, 32), ("floor", 5, 32),
    ("s_is_width", 32, 32), ("one_short", 31, 32)])
def test_padded_sequence_takes_the_real_tokens_pairs(monkeypatch, dispatch,
                                                     case, s, width):
    """A sequence of ``s`` real tokens padded to ``width`` with its real
    count: the (token, expert) pairs its real tokens take, with their
    ranks and gates, and the tokens each expert takes in its first
    cap(s) rows are the call on the s tokens alone's; the rows past
    cap(s) carry gate 0 and no token names them, the pads take no
    expert, and the real tokens' outputs agree at the MoE tolerance
    (equal bit for bit where s == width). ``ties`` repeats one token in
    every position, pads included, so every expert's cut falls among
    equal values and most routing is 0; ``floor`` puts cap(s) on the
    dispatch's floor."""
    cfg, _, params, _ = _layer("shared", dispatch=dispatch)
    if case == "ties":
        x = np.broadcast_to(_x(1, 1), (1, width, 64)).copy()
    else:
        x = _x(1, width, seed=7)
    xt = torch.from_numpy(x)
    cap_s = moe.capacity(s, cfg)
    if case == "floor":
        assert cap_s == min(moe.FLOOR[dispatch], s) > int(
            s * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    want = _plan_of(monkeypatch, params, xt[:, :s], cfg)
    got = _plan_of(monkeypatch, params, xt, cfg, _real(s, cfg))
    out, top_idx, gate, tok, src = got
    assert tok.shape[-1] == moe.capacity(width, cfg) >= cap_s
    assert _taken(top_idx, src, tok.shape[-1], s) == _taken(
        want[1], want[4], cap_s, s)
    assert torch.equal(tok[:, :cap_s], want[3])
    assert torch.equal(gate[:, :cap_s], want[2])
    assert not gate[:, cap_s:].any()
    assert bool((src[s:] == -1).all()), "a pad reached an expert"
    if case == "ties":
        assert len(_taken(top_idx, src, tok.shape[-1], s)) < \
            s * cfg.top_k, "no pair dropped at the cut among ties"
    if s == width:
        assert torch.equal(out, want[0])
    else:
        np.testing.assert_allclose(out[:s].numpy(), want[0].numpy(),
                                   **MOE_TOL)


def _apply_moe_as_before(params, x, cfg):
    """``apply_moe`` (global dispatch, shared expert, no tracing) as it
    was before the real-token count, from the module's primitives."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    routing, probs, top_idx = moe._routing(params, xf, cfg)
    gate_ec, tok_ec = moe._top_k(routing.T, moe._capacity(b * s, cfg, 8))
    tok = tok_ec.reshape(-1)
    expert = torch.arange(tok_ec.shape[-2])[:, None]
    rows = torch.full((b * s, tok_ec.shape[-2]), -1, dtype=torch.long)
    rows[tok, expert.expand(tok_ec.shape).reshape(-1)] = \
        torch.arange(tok.numel())
    src = rows.gather(1, top_idx)
    x_ec = moe._Gather.apply(xf, tok, src).reshape(*tok_ec.shape, -1)
    y_ec = moe._experts(params, x_ec) * gate_ec[..., None]
    out = moe._Combine.apply(y_ec.reshape(tok.numel(), -1), tok, src)
    sh = (torch.nn.functional.silu(xf @ params["shared_gate"])
          * (xf @ params["shared_up"])) @ params["shared_down"]
    out = out + torch.sigmoid(xf @ params["shared_router"]) * sh
    frac_tokens = torch.nn.functional.one_hot(
        top_idx, cfg.e_total).float().mean(dim=(0, 1))
    aux = cfg.n_experts * (frac_tokens * probs.mean(dim=0)).sum() \
        * cfg.aux_coef
    return out.reshape(b, s, d), aux


def test_without_real_tokens_the_moe_is_unchanged_bit_for_bit():
    """Without the count, ``apply_moe``'s output, aux loss and every
    gradient equal the dispatch's as it was before the count existed,
    bit for bit, with tokens dropped at the capacity cut."""
    cfg, _, params, _ = _layer("shared")
    x = torch.from_numpy(_x(2, 32))
    results = []
    for fn in (moe.apply_moe, _apply_moe_as_before):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xi = x.clone().requires_grad_(True)
        out, aux = fn(p, xi, cfg)
        ((out * out).sum() + aux).backward()
        results.append([out, aux, xi.grad] + [p[k].grad for k in sorted(p)])
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_real_tokens_take_one_sequence():
    cfg, _, params, _ = _layer("shared")
    with pytest.raises(ValueError, match="one sequence"):
        moe.apply_moe(params, torch.from_numpy(_x(2, 8)), cfg,
                      real=_real(4, cfg))


# --------------------------------------------------------------------------
# reduced models
# --------------------------------------------------------------------------

def _pair(arch, **overrides):
    """(port model, reference model, port params, reference params)."""
    ref_model = RefModel(ref_registry.reduced_config(arch, **overrides))
    ref_params = ref_model.init(jax.random.key(0))
    port = Model(reduced_config(arch, **overrides), device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return port, ref_model, params, ref_params


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_with_drops_match_reference(arch):
    """At the default capacity factor, where a 12-token prefill and a
    2-token decode batch drop other tokens than the forward would: the
    port's prefill logits, cache and decode logits against the
    reference's own (the drop-free comparison with the forward is in
    tests/test_torch_model.py)."""
    port, ref_model, params, ref_params = _pair(arch)
    b, k, n = 2, 12, 16
    tokens = _tokens(port.cfg, b, n)
    tt, jt = torch.from_numpy(tokens), jnp.asarray(tokens)
    got, cache = port.prefill(params, {"tokens": tt[:, :k]}, max_len=n + 4)
    want, ref_cache = ref_model.prefill(ref_params, {"tokens": jt[:, :k]},
                                        max_len=n + 4)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                               **DEC_TOL)
    for c, w in zip(jax.tree.leaves(bridge.to_numpy(cache)),
                    jax.tree.leaves(ref_cache)):
        np.testing.assert_allclose(c, np.asarray(w), **DEC_TOL)
    for i in range(k, n):
        got, cache = port.decode_step(params, cache, tt[:, i:i + 1])
        want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                jt[:, i:i + 1])
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                                   **DEC_TOL, err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_match_reference_engine(arch):
    port, ref_model, params, ref_params = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, port.cfg.vocab, size=n) for n in (5, 9, 3)]
    ref_q, port_q = RefQueue(), RequestQueue()
    for prompt in prompts:
        ref_q.submit(prompt, max_new_tokens=6)
        port_q.submit(prompt, max_new_tokens=6)
    want = RefEngine(ref_model, ref_params, n_slots=2, max_len=32).run(ref_q)
    got = ServeEngine(port, params, n_slots=2, max_len=32).run(port_q)
    assert {r.uid: r.tokens for r in got} == {r.uid: r.tokens for r in want}


@pytest.fixture(scope="module")
def reference():
    """Per MoE arch (reduced, 2 layers): the reference model, its params,
    the reference dataset's batch, and its jitted loss and gradients."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = ref_registry.reduced_config(arch, n_layers=2)
        model = RefModel(cfg)
        params = model.init(jax.random.key(0))
        ds = ref_data.SyntheticDataset(vocab=cfg.vocab, seq_len=16,
                                       global_batch=8)
        batch = {k: np.asarray(v, np.int64)
                 for k, v in ds.batch_at(0).items()}
        (loss, parts), grads = jax.jit(jax.value_and_grad(
            model.loss, has_aux=True))(
                params, {k: jnp.asarray(v, jnp.int32)
                         for k, v in batch.items()})
        out[arch] = dict(params=params, batch=batch, loss=float(loss),
                         aux=float(parts["aux"]), grads=grads)
    return out


def _port_loss_grads(arch, reference, remat):
    model = Model(reduced_config(arch, n_layers=2, remat=remat),
                  device="cpu")
    params = bridge.from_reference(
        jax.tree.map(np.asarray, reference[arch]["params"]), device="cpu")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    batch = {k: torch.from_numpy(v)
             for k, v in reference[arch]["batch"].items()}
    loss, parts = model.loss(tree_map(lambda _: next(it), params), batch)
    return model, leaves, loss, parts


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_and_grads_match_reference(reference, arch, remat):
    """Model.loss (CE + the layers' aux) and its gradients against
    jax.value_and_grad."""
    ref = reference[arch]
    _, leaves, loss, parts = _port_loss_grads(arch, reference, remat)
    grads = torch.autograd.grad(loss, leaves)
    loss, aux = float(loss.detach()), float(parts["aux"].detach())
    np.testing.assert_allclose(loss, ref["loss"], **GRAD_TOL)
    np.testing.assert_allclose(aux, ref["aux"], **GRAD_TOL)
    assert aux > 0.0
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref["grads"]))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops run while it is active."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] = self.n.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_router_and_shared_products_recomputes_experts(
        reference):
    """In backward, remat "dots" runs no 2-D matmul again (the router and
    shared-expert products are saved, like the projections) and runs the
    batched products again: per layer the three expert products and
    attention's two, as "full" does. Gradients are bit-equal to "none"."""
    aten = torch.ops.aten
    counts, grads = {}, {}
    for remat in ("none", "dots", "full"):
        model, leaves, loss, _ = _port_loss_grads("qwen2-moe-a2.7b",
                                                  reference, remat)
        with _OpCount() as count:
            grads[remat] = torch.autograd.grad(loss, leaves)
        counts[remat] = count.n
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b)
                   for a, b in zip(grads[remat], grads["none"])), remat
    mm = lambda r: counts[r].get(aten.mm.default, 0)
    bmm = lambda r: counts[r].get(aten.bmm.default, 0)
    n = model.cfg.n_layers
    assert mm("dots") == mm("none") < mm("full")
    assert bmm("dots") == bmm("full") == bmm("none") + n * (3 + 2)


def test_moe_checkpoint_restores_in_reference(tmp_path):
    """A port train state of reduced qwen2-moe (router, experts, shared
    expert leaves) written by the port, read back by the port and by the
    reference."""
    cfg = ref_registry.reduced_config("qwen2-moe-a2.7b", n_layers=2)
    ref_state = ref_adamw_init(RefModel(cfg).init(jax.random.key(0)))
    assert "shared_router" in ref_state["params"]["layers"]["moe"]
    state = bridge.from_reference(jax.tree.map(np.asarray, ref_state),
                                  device="cpu")
    assert sorted(state["m"]["layers"]["moe"]) == sorted(
        adamw_init(state["params"])["m"]["layers"]["moe"])
    d = str(tmp_path / "port")
    save_checkpoint(d, 3, state)
    back, step, _ = restore_checkpoint(d, like=state)
    assert step == 3 and all(torch.equal(a, b) for a, b in zip(
        tree_leaves(back), tree_leaves(state)))
    got, step, _ = ref_ckpt.restore_checkpoint(d, like=ref_state)
    assert step == 3
    assert jax.tree.structure(got) == jax.tree.structure(ref_state)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_n_active_params_matches_reference(arch):
    want = ref_registry.get_config(arch)
    got = get_config(arch)
    assert got.n_active_params() == want.n_active_params()
    assert got.n_active_params() < got.n_params()
    assert reduced_config(arch).n_active_params() == \
        ref_registry.reduced_config(arch).n_active_params()
    dense = get_config("qwen3-0.6b")
    assert dense.n_active_params() == dense.n_params()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_stack_params_draws_as_stacking_the_layers_did(arch):
    """The stack filled layer by layer holds the values that stacking n
    separately drawn layers gave, in the same draw order."""
    from repro_torch.models.transformer import (make_decoder_block,
                                                stack_params)
    cfg = reduced_config(arch)
    bcfg = cfg.block_cfg()

    def layers(build):
        gen = torch.Generator().manual_seed(0)
        return build(cfg.n_layers, lambda: make_decoder_block(
            gen, bcfg, torch.float32, "cpu"))

    got = layers(stack_params)
    want = layers(lambda n, maker: tree_map(lambda *xs: torch.stack(xs),
                                            *[maker() for _ in range(n)]))
    assert "moe" in got and got["moe"]["gate"].shape[0] == cfg.n_layers
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(got), tree_leaves(want)))


def test_launcher_trains_reduced_moe_on_cpu(tmp_path, capsys):
    ck = tmp_path / "ck"
    assert launch_train.main(
        ["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
         "--steps", "4", "--batch", "4", "--seq", "16", "--ckpt-every", "2",
         "--remat", "dots", "--ckpt-dir", str(ck)]) == 0
    assert "done: 4 steps, 0 failures" in capsys.readouterr().out
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000002",
                                                    "step_00000004"]
