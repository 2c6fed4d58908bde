"""Data pipelines of the port: the synthetic token pipeline and the
FREYJA-augmented tabular path."""
from repro_torch.data.pipeline import TokenPipeline, augmented_table_pipeline

__all__ = ["TokenPipeline", "augmented_table_pipeline"]
