from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset, make_batches

__all__ = ["DataConfig", "SyntheticLMDataset", "make_batches"]
