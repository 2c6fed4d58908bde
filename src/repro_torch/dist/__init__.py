"""Distributed utilities: logical-axis sharding rules + gradient compression,
on the port's single-controller ``DeviceMesh``."""
from repro_torch.dist.compression import make_int8_ef_allreduce
from repro_torch.dist.sharding import (batch_axes, get_mode, param_shardings, set_mode,
                                       spec_of, zero1_shardings)

__all__ = ["batch_axes", "get_mode", "param_shardings", "set_mode", "spec_of",
           "zero1_shardings", "make_int8_ef_allreduce"]
