"""The synthetic LM data pipeline (the port's own numpy copy)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    SyntheticLMDataset,
    make_batch_iterator,
)
