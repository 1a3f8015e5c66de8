"""Whether what the timed path served is correct.

Once the window has closed and the peak memory is read, a sample of the
requests the run finished, drawn from the seed, with the longest in it
and one of every slot, is held against the plain fp32 reference: prompt
and served tokens are fed to the reference, and for every served token
the gap by which its reference logit lies below the reference's best is
read. The widest gap over the sample (``logit_gap``) or the mean gap
over all its served tokens (``logit_gap_mean``) is compared with the
cell's limit (``cells/<cell>.json``: ``limits``). With ``control`` the
reference is also run in fp8 in the program's place, the gap of the
token that it puts first is read at the same positions, and the same
limits judge those readings (``within``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import spec
from perfbench.reference.common import Precision, exact_fp32


def sample(s, cell, seed: int, t_end: float) -> List:
    """The compared requests: the longest finished one (prompt and served
    tokens), then, in an order drawn from the seed, one finished request
    of every slot that finished one (so no slot of the batch goes
    unchecked), then others until the served tokens reach
    ``check_tokens``."""
    open_loop = cell.mix["loop"] == "open"
    done = [tr for tr in s.tracked.values()
            if tr.done_at is not None and tr.done_at <= t_end
            and (tr.timeline.arrival is not None or not open_loop)]
    if not done:
        return []
    slot_of = {u: slot for c in s.calls for slot, u in c.adm}
    size = lambda tr: len(tr.req.prompt) + len(tr.req.generated)
    longest = max(done, key=lambda tr: (size(tr), -tr.req.uid))
    rest = [tr for tr in done if tr is not longest]
    order = [rest[i] for i in np.random.default_rng([seed, 2]).permutation(
        len(rest))]
    picked = [longest]
    slots = {slot_of[longest.req.uid]}
    for tr in order:
        if slot_of[tr.req.uid] not in slots:
            picked.append(tr)
            slots.add(slot_of[tr.req.uid])
    served = sum(len(tr.req.generated) for tr in picked)
    for tr in order:
        if served >= int(cell.data["check_tokens"]):
            break
        if tr not in picked:
            picked.append(tr)
            served += len(tr.req.generated)
    return picked


def within(readings: Dict[str, float], limits: Dict[str, float],
           prefix: str = "") -> bool:
    """Whether every limited reading (the program's, or with ``prefix``
    ``"control_"`` the control's) is there and at most its limit: the one
    test that decides ``correct``, for the program and the control."""
    return all(readings.get(prefix + k) is not None
               and readings[prefix + k] <= lim for k, lim in limits.items())


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ref (n, vocab) logits; the gap of each token below the best."""
    return ref.max(-1).values - ref.gather(1, tokens[:, None])[:, 0]


def _free_program_state(s):
    s.engine.cache = None
    s.engine.last_tokens = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def run(s, cell, seed: int, t_end: float, control: bool = False
        ) -> Tuple[Dict[str, float], Dict[int, Dict[str, float]]]:
    """(readings, each compared request's own readings). ``logit_gap`` is
    the widest gap over the sample, ``logit_gap_mean`` the mean over all
    its served tokens; the control's are ``control_*``."""
    picked = sample(s, cell, seed, t_end)
    _free_program_state(s)
    if not picked:
        return {}, {}
    ref = spec.reference(cell.bench_dir, cell.config)
    precs = [Precision("fp32")] + ([Precision("fp8")] if control else [])
    with torch.inference_mode(), exact_fp32():
        if ref.COUPLED_ROWS:
            per = _replay(s, ref, picked, precs)
        else:
            per = _alone(s, ref, picked, precs)
    own = {uid: {"logit_gap": float(g[0].max()),
                 "logit_gap_mean": float(g[0].mean())}
           for uid, g in per.items()}
    readings = {}
    for i, prefix in enumerate(["", "control_"][:len(precs)]):
        allg = torch.cat([g[i] for g in per.values()])
        readings[prefix + "logit_gap"] = float(allg.max())
        readings[prefix + "logit_gap_mean"] = float(allg.mean())
    return readings, own


def _alone(s, ref, picked, precs) -> Dict[int, List[torch.Tensor]]:
    """Rows that do not interact: one causal pass per request."""
    out = {}
    for tr in picked:
        prompt = torch.as_tensor(tr.req.prompt, dtype=torch.long,
                                 device=s.device)
        gen = torch.as_tensor(tr.req.generated, dtype=torch.long,
                              device=s.device)
        seq = torch.cat([prompt, gen[:-1]])
        pos = torch.arange(len(prompt) - 1, len(seq), device=s.device)
        lg = [ref.forward(s.params, s.m, seq, pos, p) for p in precs]
        gaps = [_gaps(lg[0], gen)]
        if len(lg) > 1:
            gaps.append(_gaps(lg[0], lg[1].argmax(-1)))
        out[tr.req.uid] = gaps
    return out


def _replay(s, ref, picked, precs) -> Dict[int, List[torch.Tensor]]:
    """Rows coupled in a step: every engine call since the engine was made
    is replayed, the same requests in the same slots, fed the served
    tokens."""
    want = {tr.req.uid for tr in picked}
    reqs = {uid: tr.req for uid, tr in s.tracked.items()}
    reps = [ref.Replay(s.params, s.m, s.n_slots, s.max_len, p, s.device)
            for p in precs]
    got: Dict[int, List[List[torch.Tensor]]] = {u: [[] for _ in precs]
                                                 for u in want}
    feed = torch.zeros(s.n_slots, dtype=torch.long, device=s.device)
    pos: Dict[int, int] = {}

    def note(uid, k, logits):
        if uid in want:
            tok = torch.tensor([reqs[uid].generated[k]], device=s.device)
            got[uid][0].append(_gaps(logits[0][None], tok))
            if len(logits) > 1:
                got[uid][1].append(_gaps(logits[0][None],
                                         logits[1].argmax()[None]))

    for call in s.calls:
        for slot, uid in call.adm:
            prompt = torch.as_tensor(reqs[uid].prompt, dtype=torch.long,
                                     device=s.device)
            note(uid, 0, [r.prefill(slot, prompt) for r in reps])
            feed[slot] = reqs[uid].generated[0]
            pos[uid] = 1
        if not call.dec:
            continue
        lg = [r.decode(feed) for r in reps]
        feed = torch.zeros_like(feed)
        for slot, uid in enumerate(call.occ):
            if uid is None:
                continue
            note(uid, pos[uid], [x[slot] for x in lg])
            feed[slot] = reqs[uid].generated[pos[uid]]
            pos[uid] += 1
        if all(pos.get(u, 0) >= len(reqs[u].generated) for u in want):
            break
    return {u: [torch.cat(g) for g in v] for u, v in got.items()}
