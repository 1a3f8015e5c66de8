"""Architecture configs of the ported families (see ``registry``) and
the four input-shape cells (``shapes``)."""
from repro_torch.configs.registry import (ARCH_IDS, PORT_ARCH_IDS,
                                         get_config, reduced_config)
from repro_torch.configs.shapes import SHAPES, Shape, cells_for, input_shape

__all__ = ["ARCH_IDS", "PORT_ARCH_IDS", "get_config", "reduced_config",
           "SHAPES", "Shape", "cells_for", "input_shape"]
