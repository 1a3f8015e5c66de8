"""Roofline constants of the port's target card, and the per-family unit
counts the stage graphs read (copied from ``repro.roofline``)."""
from repro_torch.roofline.hw import H100_SXM, HardwareSpec

__all__ = ["H100_SXM", "HardwareSpec"]
