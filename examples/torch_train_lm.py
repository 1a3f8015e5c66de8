"""End-to-end run of the PyTorch port: train a ~100M-param
OLMo-family model for a few hundred steps with the full stack (AdamW,
microbatch gradient accumulation, checkpoints, the fault-tolerant loop);
the twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

It trains on the CUDA card unless ``--device`` says otherwise. (~110M
params is the d=640/L=12 point of the olmo family; the published olmo-1b
trains the same way via ``python -m repro_torch.launch.train --arch
olmo-1b``.)
"""
import argparse
import dataclasses

import repro_torch.configs.registry as reg
import repro_torch.launch.train as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card if not given")
    args = ap.parse_args()

    # ~100M-param family member: olmo geometry at d=640, L=12 (~110M)
    cfg = dataclasses.replace(
        reg.get_config("olmo-1b"), name="olmo-100m", n_layers=12,
        d_model=640, n_heads=10, kv_heads=10, head_dim=64, d_ff=2560,
        dtype="float32", remat="none")
    # register a transient arch id so the standard launcher can run it (its
    # --arch choices are the registry's list, read when it parses)
    reg.CONFIGS["olmo-100m"] = cfg
    reg.ARCH_IDS.append("olmo-100m")
    argv = ["--arch", "olmo-100m", "--steps", str(args.steps),
            "--batch", "8", "--seq", "256", "--lr", "6e-4",
            "--microbatches", "2", "--ckpt-dir", "artifacts/ckpt_100m_torch",
            "--log-every", "10"]
    if args.device:
        argv += ["--device", args.device]
    return T.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
