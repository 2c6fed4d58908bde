"""The frozen quality model: the program and the reference read the same
ensemble from the one file, and it is the one its provenance describes."""
import json

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import plain
from repro_torch.core.predictor import JoinQualityModel, gbdt_predict_ref, gbdt_to_torch

MODEL = harness.PB / "model" / "quality_gbdt.npz"


def test_program_and_reference_load_the_same_ensemble():
    prog = JoinQualityModel.load(str(MODEL))
    ref = plain.Ensemble.load(str(MODEL), "cpu")
    assert np.array_equal(prog.gbdt.feats, ref.feats.numpy())
    assert np.array_equal(np.asarray(prog.gbdt.thrs, np.float32), ref.thrs.numpy())
    assert np.array_equal(np.asarray(prog.gbdt.leaves, np.float32), ref.leaves.numpy())
    assert np.float32(prog.gbdt.base) == np.float32(ref.base)
    assert (prog.gbdt.n_trees, prog.gbdt.depth) == (50, 5)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4096, 23)).astype(np.float32))
    x[:, 21:] = torch.rand(4096, 2)
    want = gbdt_predict_ref(gbdt_to_torch(prog.gbdt.astuple(), "cpu"), x)
    assert torch.equal(ref(x), want)


def test_provenance_describes_the_file():
    with open(harness.PB / "model" / "provenance.json") as f:
        info = json.load(f)
    z = np.load(MODEL)
    assert info["npz_bytes"] == MODEL.stat().st_size
    assert info["feats_sum"] == int(z["feats"].sum())
    assert info["leaves_sum"] == float(np.asarray(z["leaves"], np.float64).sum())
    assert info["gbdt_config"]["n_trees"] == 50 and info["gbdt_config"]["depth"] == 5
