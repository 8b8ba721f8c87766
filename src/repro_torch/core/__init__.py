from repro_torch.core.utility import Utility, paper_utility

__all__ = ["Utility", "paper_utility"]
