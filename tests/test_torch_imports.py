"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the host unless the caller asks for it."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.lakegen import LakeSpec, generate_lake
from repro_torch.core.predictor import (JoinQualityModel, predict_scores,
                                        train_quality_model)
from repro_torch.core.profiles import profile_lake
from repro_torch.exec.executor import Executor
from repro_torch.kernels import _build
from repro_torch.launch import discover
from repro_torch.service.catalog import (CatalogSnapshot, CatalogStore,
                                         profile_and_sign)
from repro_torch.service.engine import DiscoveryEngine
from repro_torch.service.lsh import LSHConfig, LSHIndex

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["repro"] = None        # ... and of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.kernels import _build
assert not _build._libs, "a kernel was built at import"
print(" ".join(names))
"""

# modules of the scale and model paths that the walk must reach
_SCALE_MODULES = {"repro_torch.launch", "repro_torch.launch.costmodel",
                  "repro_torch.exec.plan", "repro_torch.exec.stages",
                  "repro_torch.exec.executor", "repro_torch.kernels.profile_distance",
                  "repro_torch.kernels.lsh_probe", "repro_torch.service.lsh",
                  "repro_torch.kernels.gbdt_infer", "repro_torch.kernels.quality_cdf",
                  "repro_torch.core.quality", "repro_torch.core.predictor",
                  "repro_torch.launch.discover", "repro_torch.launch.train_quality",
                  "repro_torch.launch.bench_scorer"}
# modules of the serving path
_SERVE_MODULES = {"repro_torch.service", "repro_torch.service.api",
                  "repro_torch.service.catalog", "repro_torch.service.compactor",
                  "repro_torch.service.engine", "repro_torch.service.events",
                  "repro_torch.service.loadgen", "repro_torch.service.metrics",
                  "repro_torch.service.scheduler", "repro_torch.core.sketches",
                  "repro_torch.core.profiles", "repro_torch.kernels.ref"}


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 29                     # every module was imported
    assert _SCALE_MODULES <= names, _SCALE_MODULES - names
    assert _SERVE_MODULES <= names, _SERVE_MODULES - names


def test_kernel_sources_are_keyed_by_content():
    libs = (*_build.KERNELS, *_build.HARNESS)
    paths = {name: _build.library_path(name) for name in libs}
    assert len(set(paths.values())) == len(libs)
    assert set(_build._SIGNATURES) == set(libs)     # every library's entry points declared
    for name, path in paths.items():
        assert path.parent == _build.BUILD_DIR and name in path.name
        assert path == _build.library_path(name)      # stable for one source
    # both scorers, the distance kernel and the ensemble include the shared
    # body; the other kernels include nothing
    assert _build.sources("fused_score") == ["fused_score.cu", "fused_score.cuh"]
    assert _build.sources("fused_score_q") == ["fused_score.cuh", "fused_score_q.cu"]
    assert _build.sources("profile_distance") == ["fused_score.cuh", "profile_distance.cu"]
    assert _build.sources("gbdt_infer") == ["fused_score.cuh", "gbdt_infer.cu"]
    assert _build.sources("minhash") == ["minhash.cu"]
    assert _build.sources("quality_cdf") == ["quality_cdf.cu"]


def test_an_edited_header_rebuilds_every_kernel_that_includes_it(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    with open(csrc / "fused_score.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    changed = {name for name in _build.KERNELS if before[name] != after[name]}
    assert changed == {"fused_score", "fused_score_q", "profile_distance", "gbdt_infer"}


@pytest.fixture(scope="module")
def tiny():
    lake = generate_lake(LakeSpec(n_domains=3, n_tables=3, row_budget=64, seed=1))
    prof = profile_lake(lake.batch, device="cpu")
    r = np.random.default_rng(0)
    gbdt = GBDTParams(feats=r.integers(0, 23, (2, 2)).astype(np.int32),
                      thrs=r.normal(size=(2, 2)).astype(np.float32),
                      leaves=r.normal(size=(2, 4)).astype(np.float32), base=0.0)
    return lake, prof, JoinQualityModel(gbdt=gbdt)


_ENTRY_POINTS = {
    "profile_lake": lambda lake, prof, model: profile_lake(lake.batch),
    "profile_and_sign": lambda lake, prof, model: profile_and_sign(lake.batch, 16, 0),
    "train_quality_model": lambda lake, prof, model: train_quality_model([lake]),
    "rank": lambda lake, prof, model: rank(DiscoveryIndex(prof, model), [0]),
    "Executor": lambda lake, prof, model: Executor(prof.zscored, prof.words,
                                                   model.gbdt.astuple()),
    "LSHIndex.hit_mask": lambda lake, prof, model: LSHIndex.build(
        np.zeros((4, 16), np.uint32), LSHConfig(n_bands=4)).hit_mask(
            np.zeros((1, 4), np.uint32)),
    "LSHIndex.coarse_hit_mask": lambda lake, prof, model: LSHIndex.build(
        np.zeros((4, 16), np.uint32), LSHConfig(n_bands=4)).coarse_hit_mask(
            np.zeros((1, 16), np.uint32)),
    "Executor(int8)": lambda lake, prof, model: Executor(
        prof.zscored, prof.words, model.gbdt.astuple(), profile_dtype="int8"),
    "predict_scores": lambda lake, prof, model: predict_scores(model, prof, [0]),
    "launch.discover.main": lambda lake, prof, model: discover.main(
        ["--tables", "3", "--domains", "3"]),
    "CatalogStore": lambda lake, prof, model: CatalogStore(
        os.path.join(os.path.dirname(__file__), "no-such-catalog-dir")),
    "DiscoveryEngine": lambda lake, prof, model: DiscoveryEngine(
        _empty_snapshot(), model),
    "launch.discover.main --serve": lambda lake, prof, model: discover.main(
        ["--tables", "3", "--domains", "3", "--model", "unused.npz",
         "--catalog", "unused", "--serve"]),
}


def _empty_snapshot() -> CatalogSnapshot:
    return CatalogSnapshot(profiles=profile_lake(
        generate_lake(LakeSpec(n_domains=1, n_tables=1, row_budget=16, seed=0)).batch,
        device="cpu"), signatures=np.zeros((1, 16), np.uint32),
        table_ids=np.zeros((1,), np.int32), names=["c"], table_names={0: "t"},
        version=0)


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_point_without_device_raises_on_a_host_without_a_card(
        monkeypatch, tiny, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[entry](*tiny)
