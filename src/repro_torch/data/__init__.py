from repro_torch.data.pipeline import DataConfig, PrefetchIterator, SyntheticLMStream  # noqa: F401
