"""Carry state from the JAX package into the port.

Both packages keep their state in numpy arrays of the same layout, so a
conversion is a typed copy. The functions take the JAX package's objects by
duck type and import nothing of it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.profiles import LakeProfiles


def gbdt_from_jax(params) -> GBDTParams:
    """``repro.core.gbdt.GBDTParams`` -> the port's ``GBDTParams``."""
    return GBDTParams(feats=np.asarray(params.feats, np.int32).copy(),
                      thrs=np.asarray(params.thrs, np.float32).copy(),
                      leaves=np.asarray(params.leaves, np.float32).copy(),
                      base=float(params.base))


def profiles_from_jax(profiles) -> LakeProfiles:
    """``repro.core.profiles.LakeProfiles`` -> the port's ``LakeProfiles``."""
    return LakeProfiles(numeric=np.asarray(profiles.numeric, np.float32).copy(),
                        words=np.asarray(profiles.words, np.uint32).copy(),
                        n_rows=np.asarray(profiles.n_rows, np.int32).copy(),
                        mean=np.asarray(profiles.mean, np.float32).copy(),
                        std=np.asarray(profiles.std, np.float32).copy())
