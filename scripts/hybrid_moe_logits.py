"""granite-4.0-h-small at the cut of ``perfbench/configs/`` (20 layers,
published widths, bf16, the CUDA kernels) on the card: how far the program's logits
lie from the benchmark's plain fp32 reference, and how far the
reference's own fp8 control lies from it, at every position a few
requests are served at.

    PYTHONPATH=src:. python3 scripts/hybrid_moe_logits.py \
        [--slots 8] [--steps 16] [--seed 1]

Each slot is prefilled alone and copied into the batch cache, as the
engine admits a request; then every slot decodes ``--steps`` greedy
steps together, fed the program's own tokens, and the reference
(``perfbench/reference/hybrid_moe.py``, ``Replay``) follows the same
batch in fp32 and in fp8. The weights are the benchmark's
(``perfbench/weights.py``). Prints one JSON line: for the program and for
the control, the largest and the mean absolute difference from the fp32
reference's logits and the share of positions whose top token differs;
beside them the reference's largest absolute logit and the share of
positions at which its top token is the token that row was fed.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import spec  # noqa: E402
from perfbench.reference import hybrid_moe as ref  # noqa: E402
from perfbench.reference.common import Precision, exact_fp32  # noqa: E402
from perfbench.weights import make_weights  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import _insert_slot  # noqa: E402

CONFIG = ROOT / "perfbench" / "configs" / "granite-4.0-h-small.json"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    conf = spec.load_json(CONFIG)
    m = conf["model"]
    cfg = get_config(conf["arch"], **conf["overrides"])
    dev = torch.device("cuda")
    params = make_weights(Model(cfg, device="meta").init(), args.seed, dev)
    model = Model(cfg, device=dev)
    gen = torch.Generator().manual_seed(args.seed)
    lengths = torch.randint(64, 1500, (args.slots,), generator=gen).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen).to(dev)
               for n in lengths]
    max_len = max(lengths) + args.steps + 1
    with torch.inference_mode():
        cache, axes = model.make_cache(args.slots, max_len)
        prog, feeds = [], []
        for slot, p in enumerate(prompts):
            lg, one = model.prefill(params, {"tokens": p[None]}, max_len)
            _insert_slot(cache, one, slot, axes)
            prog.append(lg[0, -1, :cfg.vocab].float())
        feed = torch.stack(prog).argmax(-1)
        rows = [torch.stack(prog)]
        for _ in range(args.steps):
            feeds.append(feed)
            lg, cache = model.decode_step(params, cache, feed[:, None])
            rows.append(lg[:, 0, :cfg.vocab].float())
            feed = rows[-1].argmax(-1)
        prog = torch.cat(rows)
        del cache, one
        torch.cuda.empty_cache()
        out = {"config": conf["name"], "slots": args.slots, "steps": args.steps,
               "prompts": lengths, "device": torch.cuda.get_device_name(0)}
        refs = {}
        with exact_fp32():
            for kind in ("fp32", "fp8"):
                rep = ref.Replay(params, m, args.slots, max_len,
                                 Precision(kind), dev)
                got = [torch.stack([rep.prefill(s, p)
                                    for s, p in enumerate(prompts)])]
                got += [rep.decode(f) for f in feeds]
                refs[kind] = torch.cat(got)
                del rep
                torch.cuda.empty_cache()
    want = refs["fp32"]
    out["ref_max_abs_logit"] = float(want.abs().max())
    for name, got in (("program", prog), ("fp8_control", refs["fp8"])):
        diff = (got - want).abs()
        out[name] = {"max_abs_diff": float(diff.max()),
                     "mean_abs_diff": float(diff.mean()),
                     "top1_differs": float((got.argmax(-1)
                                            != want.argmax(-1)).float()
                                           .mean())}
    # the token each row was fed: the prompt's last, then the feeds
    fed = torch.cat([torch.stack([p[-1] for p in prompts])] + feeds)
    out["reference_top1_is_fed_token"] = float(
        (want.argmax(-1) == fed).float().mean())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
