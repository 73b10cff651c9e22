from .pipeline import SyntheticLMDataset, make_batch_specs

__all__ = ["SyntheticLMDataset", "make_batch_specs"]
