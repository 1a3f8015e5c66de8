from repro_torch.kernels.mla_decode.ops import mla_decode

__all__ = ["mla_decode"]
