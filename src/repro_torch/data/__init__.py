from .pipeline import SyntheticLMDataset, batch_for_step

__all__ = ["SyntheticLMDataset", "batch_for_step"]
