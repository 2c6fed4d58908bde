"""Data pipelines of the port: the FREYJA-augmented tabular path."""
from repro_torch.data.pipeline import augmented_table_pipeline

__all__ = ["augmented_table_pipeline"]
