"""Deterministic synthetic data with restart-exact skipping (counterpart
of ``repro.training.data``).

Each (seed, step, host) triple keys its own numpy generator, so

  * every host draws only its own shard of the global batch,
  * restarting from step k reproduces batch k exactly: a checkpoint
    stores only ``step``, no reader state,
  * nothing is read from disk.

``batch_specs`` gives the inputs of an (arch, shape) cell as tensors on
the meta device, and ``BATCH_AXES`` their logical axes, for the step
builders. Tokens and labels are int64 here, where the reference's are
int32: torch indexes with int64.

The stream is not the reference's (``jax.random``); parity tests feed
both packages the reference's batches. The audio and vision frontends are
stubs, as in the reference: ``frames``/``patches`` are gaussian
embeddings of the configured shape, drawn from the same stream after the
tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    family: str = "dense"
    n_frontend_tokens: int = 0
    d_model: int = 0
    dtype: str = "bfloat16"
    #: where the batches land; None is the CUDA card, as for the model
    device: DeviceLike = None

    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> Dict[str, torch.Tensor]:
        """This host's shard of the global batch of ``step``: int64
        ``tokens`` and ``labels`` (the tokens shifted by one), and for the
        audio / vision families ``frames`` / ``patches`` of shape
        (b, n_frontend_tokens, d_model) in ``dtype``."""
        if self.global_batch % host_count:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split over {host_count} hosts")
        b = self.global_batch // host_count
        device = resolve_device(self.device)
        rng = np.random.default_rng((self.seed, step, host_index))
        tokens = torch.from_numpy(
            rng.integers(0, self.vocab, (b, self.seq_len + 1))).to(device)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        stub = {"audio": "frames", "vlm": "patches"}.get(self.family)
        if stub is not None:
            emb = rng.standard_normal((b, self.n_frontend_tokens,
                                       self.d_model), dtype=np.float32)
            batch[stub] = torch.from_numpy(emb).to(device,
                                                   getattr(torch, self.dtype))
        return batch


def batch_specs(cfg, shape, *, kind: str = "train") -> Dict[str, torch.Tensor]:
    """Meta-device tensors for every model input of an (arch, shape) cell.

    kind: "train" -> tokens+labels; "prefill" -> tokens; "decode" ->
    single-token step (cache specs come from the model).
    """
    b, s = shape.global_batch, shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    if kind == "train":
        specs = {"tokens": meta((b, s), torch.int64),
                 "labels": meta((b, s), torch.int64)}
    elif kind == "prefill":
        specs = {"tokens": meta((b, s), torch.int64)}
    elif kind == "decode":
        specs = {"tokens": meta((b, 1), torch.int64)}
    else:
        raise ValueError(kind)
    stub = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if stub is not None and kind != "decode":
        specs[stub] = meta((b, cfg.n_frontend_tokens, cfg.d_model),
                           getattr(torch, cfg.dtype))
    return specs


#: logical sharding axes for every batch input (batch over data axes)
BATCH_AXES = {"tokens": ("batch", "act_seq"),
              "labels": ("batch", "act_seq"),
              "frames": ("batch", None, None),
              "patches": ("batch", None, None)}


def batch_axes_for(specs: Dict) -> Dict:
    return {k: BATCH_AXES[k] for k in specs}
