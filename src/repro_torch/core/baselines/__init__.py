"""The paper's two baselines (BO, MAFF), copied from ``repro.core.baselines``."""
from repro_torch.core.baselines.bo import BayesianOptimizer, bo_search
from repro_torch.core.baselines.maff import maff_search

__all__ = ["BayesianOptimizer", "bo_search", "maff_search"]
