"""Roofline constants of the port's target card, the per-step counts and
three-term roofline of a step run on a mesh, and the per-family unit
counts the stage graphs and the depth extrapolation read (the
counterpart of ``repro.roofline``)."""
from repro_torch.roofline.hw import H100_SXM, HardwareSpec

__all__ = ["H100_SXM", "HardwareSpec"]
