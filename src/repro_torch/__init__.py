"""PyTorch/CUDA port of the FREYJA discovery system (see ``repro`` for the
JAX reference it is held against)."""
