"""FREYJA core in torch: profiles, predictor, labels and discovery.

The JAX package's names, loaded on first use: ``core.predictor`` and
``core.quality`` import the kernels, whose plain versions import
``core.features``, so importing every submodule here would make a kernel
module imported first find this package half-initialised.
"""
import importlib

_FROM = {
    "discovery": ("DiscoveryIndex", "rank", "rank_sharded"),
    "gbdt": ("GBDTConfig", "GBDTParams", "fit_gbdt"),
    "ingest": ("ColumnBatch", "ColumnSketch", "ingest_string_columns"),
    "lakegen": ("Lake", "LakeSpec", "ScaledLake", "ScaledLakeSpec", "generate_lake",
                "generate_scaled_lake", "select_queries", "select_scaled_queries"),
    "predictor": ("JoinQualityModel", "build_training_set", "train_quality_model"),
    "profiles": ("LakeProfiles", "profile_lake"),
    "quality": ("cardinality_proportion", "containment", "continuous_quality",
                "discrete_quality", "multiset_jaccard", "set_jaccard"),
}
_MODULE_OF = {name: mod for mod, names in _FROM.items() for name in names}

__all__ = ["features", *_MODULE_OF]


def __getattr__(name: str):
    if name == "features":
        return importlib.import_module(f"{__name__}.features")
    if name in _MODULE_OF:
        return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
