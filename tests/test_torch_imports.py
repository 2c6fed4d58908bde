"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the host unless the caller asks for it."""
import importlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.discovery import DiscoveryIndex, rank, rank_sharded
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.lakegen import LakeSpec, generate_lake
from repro_torch.core.predictor import (JoinQualityModel, predict_scores,
                                        train_quality_model)
from repro_torch.core.profiles import profile_lake
from repro_torch.exec.executor import Executor
from repro_torch.kernels import _build
from repro_torch.launch import discover
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (make_grid_mesh, make_local_mesh, make_replica_devices,
                                     make_replica_meshes)
from repro_torch.models import registry as lm_registry
from repro_torch.serve.engine import generate
from repro_torch.service.catalog import (CatalogSnapshot, CatalogStore,
                                         profile_and_sign)
from repro_torch.service.engine import DiscoveryEngine
from repro_torch.service.fleet import EngineFleet
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
# modules of the replica fleet and the examples' pipeline
_FLEET_MODULES = {"repro_torch.service.fleet", "repro_torch.launch.mesh",
                  "repro_torch.data", "repro_torch.data.pipeline"}
# modules of the multi-device plans
_GRID_MODULES = {"repro_torch.exec.sharded", "repro_torch.launch.mesh",
                 "repro_torch.core.discovery"}
# modules of the language-model serving path
_LM_MODULES = {f"repro_torch.models.{m}" for m in (
    "config", "layers", "attention", "moe", "rwkv", "ssm", "transformer", "encdec",
    "registry")} | {f"repro_torch.configs.{m}" for m in (
        "smollm_360m", "stablelm_3b", "qwen3_4b", "qwen15_32b", "mixtral_8x22b", "phi35_moe",
        "zamba2_27b", "whisper_base", "phi3_vision", "rwkv6_3b", "freyja_discovery")} | {
    "repro_torch.serve", "repro_torch.serve.engine", "repro_torch.launch.serve"}
# modules of the language-model training path
_TRAIN_MODULES = {"repro_torch.train", "repro_torch.train.optimizer",
                  "repro_torch.train.trainer", "repro_torch.train.loop", "repro_torch.ckpt",
                  "repro_torch.ckpt.manager", "repro_torch.launch.train",
                  "repro_torch.convert", "repro_torch.data.pipeline"}
# modules of the language-model sharding
_DIST_MODULES = {"repro_torch.dist", "repro_torch.dist.sharding",
                 "repro_torch.dist.collectives", "repro_torch.dist.compression"}
# modules of the dry run
_DRYRUN_MODULES = {"repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
                   "repro_torch.launch.costmodel"}
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 29                     # every module was imported
    assert _SCALE_MODULES <= names, _SCALE_MODULES - names
    assert _SERVE_MODULES <= names, _SERVE_MODULES - names
    assert _FLEET_MODULES <= names, _FLEET_MODULES - names
    assert _GRID_MODULES <= names, _GRID_MODULES - names
    assert _LM_MODULES <= names, _LM_MODULES - names
    assert _TRAIN_MODULES <= names, _TRAIN_MODULES - names
    assert _DIST_MODULES <= names, _DIST_MODULES - names
    assert _DRYRUN_MODULES <= names, _DRYRUN_MODULES - names


_EACH_FIRST = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    for loaded in [k for k in sys.modules if k.startswith("repro_torch")]:
        del sys.modules[loaded]
    importlib.import_module(name)
print(len(names))
"""


def test_every_module_imports_first():
    """Each module imports into an interpreter that holds no other module of
    the port (no import cycle finds a package half-initialised)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _EACH_FIRST], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 29


_EXPORTS = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch.{pkg} as pkg
for name in pkg.__all__:
    getattr(pkg, name)
print(" ".join(pkg.__all__))
"""


# the JAX package's names with no counterpart in the port: it compiles no
# XLA executables (its kernel libraries persist in build/repro_torch/)
_NOT_PORTED = {"exec": {"ExecutableCache", "environment_signature"}}


def _public(*modules) -> set[str]:
    """The names the JAX modules define (not import) and do not hide."""
    return {n for mod in modules for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", "") == mod.__name__}


# each package of the port, and the JAX package's modules whose public
# names it exports (None: the JAX package's own ``__all__``)
_PACKAGES = {"core": None, "exec": None, "data": ("data.pipeline",),
             "train": ("train.optimizer", "train.trainer", "train.loop"),
             "ckpt": ("ckpt.manager",), "dist": ("dist.sharding", "dist.compression")}


@pytest.mark.parametrize("pkg", sorted(_PACKAGES))
def test_package_exports_match_the_jax_package(pkg):
    """Each package of the port exports the JAX package's names, and they
    import without JAX."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _EXPORTS.format(pkg=pkg)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if _PACKAGES[pkg] is None:
        want = set(importlib.import_module(f"repro.{pkg}").__all__)
    else:
        want = _public(*(importlib.import_module(f"repro.{m}") for m in _PACKAGES[pkg]))
    assert set(out.stdout.split()) == want - _NOT_PORTED.get(pkg, set())


def test_no_sharded_configuration_is_left_unported():
    """Nothing in the port still names the multi-device slice as to come."""
    for path in Path(SRC, "repro_torch").rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            assert "queue 7" not in path.read_text(), path


_RUN_EXAMPLE = """
import runpy, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["repro"] = None        # ... and of the JAX package
sys.argv = [{path!r}, "--device", "cpu", *{flags!r}]
runpy.run_path({path!r}, run_name="__main__")
"""
# the training example at a small size (its defaults train 200 steps)
_EXAMPLE_FLAGS = {"torch_train_lm": ["--steps", "30", "--batch", "2", "--seq", "32",
                                     "--width", "128", "--layers", "2"]}


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_service_quickstart",
                                  "torch_follower_quickstart", "torch_discover_augment",
                                  "torch_train_lm"])
def test_example_runs_without_jax_or_repro(tmp_path, name):
    path = os.path.abspath(os.path.join(EXAMPLES, f"{name}.py"))
    flags = _EXAMPLE_FLAGS.get(name, [])
    env = dict(os.environ, TMPDIR=str(tmp_path))
    if name == "torch_train_lm":
        flags = flags + ["--ckpt-dir", str(tmp_path / "ckpt")]
        # many small ops: beside other test workers, one intra-op thread
        # (tests/_torch_train.py's one_thread)
        env["OMP_NUM_THREADS"] = "1"
    env.pop("PYTHONPATH", None)                 # the example finds the port itself
    out = subprocess.run([sys.executable, "-c", _RUN_EXAMPLE.format(path=path, flags=flags)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


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
    "EngineFleet.from_catalog": lambda lake, prof, model: EngineFleet.from_catalog(
        os.path.join(os.path.dirname(__file__), "no-such-catalog-dir"), model),
    "launch.discover.main --replicas": lambda lake, prof, model: discover.main(
        ["--tables", "3", "--domains", "3", "--model", "unused.npz",
         "--catalog", "unused", "--serve", "--replicas", "2"]),
    "launch.discover.main --mesh": lambda lake, prof, model: discover.main(
        ["--tables", "3", "--domains", "3", "--model", "unused.npz",
         "--catalog", "unused", "--serve", "--mesh", "--mode", "sharded"]),
    "make_local_mesh": lambda lake, prof, model: make_local_mesh(),
    "make_grid_mesh": lambda lake, prof, model: make_grid_mesh(1, 1),
    "make_replica_meshes": lambda lake, prof, model: make_replica_meshes(2),
    "make_replica_devices": lambda lake, prof, model: make_replica_devices(2),
    "rank_sharded": lambda lake, prof, model: rank_sharded(
        DiscoveryIndex(prof, model), [0], make_local_mesh()),
    "models.registry.init_params": lambda lake, prof, model: lm_registry.init_params(
        _LM_CFG),
    "models.registry.init_caches": lambda lake, prof, model: lm_registry.init_caches(
        _LM_CFG, 1, 8),
    "serve.engine.generate": lambda lake, prof, model: generate(
        lm_registry.init_params(_LM_CFG, device="cpu"), _LM_CFG,
        np.ones((1, 4), np.int32), max_new=2),
    "launch.serve.main": lambda lake, prof, model: launch_serve.main(
        ["--reduce", "--batch", "1", "--prompt-len", "4", "--max-new", "2"]),
    "launch.train.main": lambda lake, prof, model: launch_train.main(
        ["--reduce", "--steps", "1", "--batch", "2", "--seq", "8", "--ckpt-dir", "unused"]),
}

_LM_CFG = lm_registry.reduced_config(lm_registry.get_config("smollm-360m"))


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
