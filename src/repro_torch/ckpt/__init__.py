"""Checkpoints of the port, in the JAX package's file format."""
from repro_torch.ckpt.manager import CheckpointManager

__all__ = ["CheckpointManager"]
