"""The serving cases of tests/test_torch_serve_steps.py, in a module of
their own so that the rank subprocesses import them without JAX."""
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import reduced_config
from repro_torch.models.model import Model
from repro_torch.training.data import SyntheticDataset

#: scripts/torch_mesh_check.py's tolerances, the reference's sharded-step
#: ones (tests/test_distributed.py)
TOL = dict(atol=1e-4, rtol=1e-3)
#: prompt, cache depth, batch and greedy decode steps
SEQ, MAX_LEN, BATCH, DECODE = 16, 32, 4, 4
#: one reduced config of each family (2 layers: one shared-attention
#: application, one sLSTM block, one cross layer) in fp32 with the kernel
#: routes on; qwen3 with 2 kv heads (a GQA group of 2, as in its full
#: config) and also with the int8 KV cache
CASES = {
    "olmo-1b": ("olmo-1b", {}),
    "qwen3-0.6b": ("qwen3-0.6b", {"kv_heads": 2}),
    "qwen3-0.6b int8": ("qwen3-0.6b", {"kv_cache_quant": True}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
    "zamba2-1.2b": ("zamba2-1.2b", {"use_ssm_kernel": True}),
    "xlstm-350m": ("xlstm-350m", {}),
    "whisper-tiny": ("whisper-tiny", {}),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
}
#: the vision model's cross-layer gates start at 0, where a cross layer
#: adds nothing: opened as in tests/test_torch_cross.py
GATES = {"gate_attn": 0.5, "gate_mlp": -0.75}


def case_config(name):
    arch, over = CASES[name]
    return reduced_config(arch, n_layers=2, attn_impl="kernel", **over)


def case_inputs(cfg):
    """Seed-0 weights (vision gates opened) and a seed-0 prompt batch."""
    params = Model(cfg, device="cpu").init(seed=0)
    if cfg.family == "vlm":
        for name, value in GATES.items():
            params["segments"]["cross"][name].fill_(value)
    batch = SyntheticDataset(
        vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, family=cfg.family,
        n_frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model,
        dtype=cfg.dtype, device="cpu").batch_at(0)
    batch.pop("labels")
    return params, batch


def heads_dim(kernel: str) -> int:
    """The head dim of a kernel's first argument: flash's q (b, s, h, d),
    the SSD intra pass's x (b, chunks, q, h, p)."""
    return {"flash_attention": 2, "ssd_intra": 3}[kernel]


def record_kernel_calls(monkeypatch=None) -> list:
    """Wrap the flash and SSD-intra entry points so that every call
    appends (kernel, its first argument's shape, its head counts) to the
    returned list, after checking that each
    tensor argument is a plain tensor whose head_dim is contiguous and
    whose batch, seq and head strides are multiples of 16 bytes in bf16
    (8 elements), as the bf16 flash kernel takes them without a copy."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    calls: list = []

    def recording(module, name):
        fn = getattr(module, name)

        def call(*args, **kw):
            for t in args:
                if isinstance(t, torch.Tensor):
                    assert not isinstance(t, DTensor), name
            if name == "flash_attention":
                for t in args:
                    assert t.stride(-1) == 1 and all(
                        st % 8 == 0 for st, n in zip(t.stride()[:3],
                                                     t.shape[:3]) if n > 1)
            # the head counts that must both divide the model axis for
            # the heads to shard: flash's q and k/v heads, the SSD's heads
            heads = (tuple(a.shape[2] for a in args[:2])
                     if name == "flash_attention" else (args[0].shape[3],))
            calls.append((name, tuple(args[0].shape), heads))
            return fn(*args, **kw)

        if monkeypatch is None:
            setattr(module, name, call)
        else:
            monkeypatch.setattr(module, name, call)

    recording(flash_ops, "flash_attention")
    recording(ssd_ops, "ssd_intra")
    return calls
