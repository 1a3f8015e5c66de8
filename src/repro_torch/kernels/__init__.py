"""Hand-written Hopper kernels of the port: one package per TPU kernel of
the reference, and two (decode attention, MLA decode) that replace none.

  flash_attention/  causal GQA flash attention, CUDA C++ for sm_90a
                    (replaces repro/kernels/flash_attention)
  rmsnorm/          fused residual-add + RMSNorm, Triton
                    (replaces repro/kernels/rmsnorm)
  ssd_scan/         the Mamba2 SSD scan's intra- and inter-chunk passes,
                    CUDA C++ for sm_90a (replaces repro/kernels/ssd_scan)
  decode_attention/ grouped split-KV decode attention over the KV cache,
                    CUDA C++ for sm_90a (replaces no TPU kernel: the
                    reference decodes with plain attention)
  mla_decode/       split-KV multi-query decode attention over a latent
                    cache (DeepSeek-V2's absorbed MLA), CUDA C++ for
                    sm_90a on the tensor cores (replaces no TPU kernel:
                    the reference has no latent attention)

Each package keeps the reference's split: ``kernel.py`` (the launch),
``ref.py`` (plain torch) and ``ops.py`` (dispatch). ``ops`` takes the
plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. Each ``ops`` module counts its kernels'
launches (``launches``; ``intra_launches`` and ``inter_launches`` for
the SSD scan). Nothing is built or imported from Triton
until a kernel is first launched. A tensor on the meta device (the dry
run's) takes the plain version too: it has no data, so nothing is hidden.

Every entry point refuses a DTensor: the launch would be handed the
wrapper, not the local shard, and nothing may gather one silently. On a
mesh the model calls the entry points inside ``sharding.per_shard``, on
each rank's local shards.

No kernel has a backward pass (nor has any Pallas kernel of the
reference), so every ``ops`` entry point refuses a call that autograd
would record, on either device: a kernel's output carries no
``grad_fn``, and the gradient would silently stop at it.
"""
import torch
from torch.distributed.tensor import DTensor

#: why a kernel entry point refuses autograd, and what to train with
NO_BACKWARD = ("the port's kernels have no backward pass (nor do the "
               "reference's Pallas kernels): train with attn_impl='plain' "
               "and use_ssm_kernel=False")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise ``ValueError`` if grad mode is on and any of ``tensors``
    requires grad; ``None`` entries are skipped."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{name}: {NO_BACKWARD}")


#: devices whose tensors take a kernel's plain version: the CPU, where no
#: kernel runs, and the meta device, whose tensors have no data
PLAIN_DEVICES = ("cpu", "meta")


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``ValueError`` if any of ``tensors`` is a DTensor; ``None``
    entries are skipped."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise ValueError(f"{name}: takes plain tensors, not DTensors; on a "
                         f"mesh call it on each rank's local shards "
                         f"(repro_torch.distributed.sharding.per_shard)")
