"""The plain reference held to hand-worked cases of both plan kinds, and its
control shown to fail the check."""
import json

import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.reference import plain

S = plain.SENTINEL


def _model(trees):
    """An ensemble of depth-1 trees: (feature, threshold, leaf below, leaf at
    or above), base 0."""
    return plain.Ensemble(
        feats=torch.tensor([[f] for f, _, _, _ in trees]),
        thrs=torch.tensor([[t] for _, t, _, _ in trees], dtype=torch.float32),
        leaves=torch.tensor([[lo, hi] for _, _, lo, hi in trees], dtype=torch.float32),
        base=0.0)


def _words(top, first):
    w = torch.full((plain.F_WORDS,), S, dtype=torch.int64)
    w[:len(top)] = torch.tensor(top, dtype=torch.int64)
    w[plain.FIRST_WORD] = first
    return w


def test_all_plan_by_hand():
    # eight columns, two a table; only z slot 0 and the top words matter.
    # tree 0: top-10 overlap >= 0.25 adds 1; tree 1: |dz0| < 0.5 adds 0.5
    z0 = [0.0, 0.1, 0.2, 1.0, 0.05, 2.0, 0.3, 0.9]
    tops = [[1, 2, 3, 4, 5], [7], [1, 2, 3], [1, 2, 3, 4], [9], [1, 2, 3, 4, 5, 6], [1], []]
    z = torch.zeros((8, plain.F_NUM))
    z[:, 0] = torch.tensor(z0)
    cols = torch.arange(8)
    lake = plain.Lake(z=z, words=torch.stack([_words(t, 100 + i) for i, t in enumerate(tops)]),
                      tables=cols // 2, cols=cols, coarse=None, values=None)
    model = _model([(plain.F_NUM, 0.25, 0.0, 1.0), (0, 0.5, 0.5, 0.0)])
    sc, ids = plain.answer_all(lake, model, torch.tensor([0, 4]), 3)
    # query 0 (its table: 0, 1): column 2 scores 1 + 0.5, columns 3 and 5
    # score 1 (the tie to the lower index), 4 and 6 score 0.5, 7 scores 0
    assert ids.tolist() == [[2, 3, 5], [0, 1, 2]]
    assert sc.tolist() == [[1.5, 1.0, 1.0], [0.5, 0.5, 0.5]]
    # a lower-precision corpus moves a column across the 0.5 threshold
    zl = z.clone()
    zl[6, 0] = 0.5
    sc2, ids2 = plain.answer_all(lake, model, torch.tensor([0]), 5, zc=zl)
    assert ids2.tolist() == [[2, 3, 5, 4, 6]] and sc2[0, 4].item() == 0.0
    exact = plain.exact_scores(lake, model, torch.tensor([0]), torch.tensor([[2, 1, -1]]))
    assert exact.tolist() == [[1.5, float("-inf"), float("-inf")]]


def test_tiered_plan_by_hand():
    # 64 columns of 16 values, two a table, blocks of 32. Column 40 holds
    # exactly column 0's values (a coarse and a fine hit for query 0); every
    # other column's values are its own. z slot 0: column c < 32 at c/100,
    # the others at 0.5 + (c - 32)/100.
    c, r = 64, 16
    values = (torch.arange(c)[:, None] * 100 + torch.arange(r)[None, :] + 5000)
    values[40] = values[0]
    z = torch.zeros((c, plain.F_NUM))
    z[:, 0] = torch.tensor([i / 100 if i < 32 else 0.5 + (i - 32) / 100 for i in range(c)])
    first = values.amin(1)
    words = torch.stack([_words([], int(f)) for f in first])
    a, b = plain.permutations(128, 0)
    rows = plain.coarse_rows(128, 16)
    coarse = plain.coarse_keys(plain.minhash(values, torch.from_numpy(a[rows].astype(np.int64)),
                                             torch.from_numpy(b[rows].astype(np.int64))))
    cols = torch.arange(c)
    lake = plain.Lake(z=z, words=words, tables=cols // 2, cols=cols, coarse=coarse,
                      values=[(0, c, values)])
    # tree 0: first-word equality adds 1; tree 1: |dz0| < 0.3 adds 0.5
    model = _model([(plain.F_NUM + 1, 0.5, 0.0, 1.0), (0, 0.3, 0.5, 0.0)])
    sc, ids = plain.answer_tiered(lake, model, torch.tensor([0]), 3, n_perm=128,
                                  minhash_seed=0, n_bands=64, survivors=40, budget=40)
    # survivors: block 1 (the hit's 32 columns), then the 8 profile-nearest
    # of block 0 (columns 2-9); column 40 scores 1, columns 2-9 score 0.5
    # (the fine proxy puts 2 before 3), block 1's others 0
    assert ids.tolist() == [[40, 2, 3]]
    assert sc.tolist() == [[1.0, 0.5, 0.5]]
    # without the digest hit, 30 survivors are the profile-nearest: block 0's
    # columns 2-31, and column 40 is not among them
    lake.coarse = torch.where(cols[:, None] == 40, 7, coarse)
    sc, ids = plain.answer_tiered(lake, model, torch.tensor([0]), 3, n_perm=128,
                                  minhash_seed=0, n_bands=64, survivors=30, budget=30)
    assert ids.tolist() == [[2, 3, 4]] and sc.tolist() == [[0.5, 0.5, 0.5]]


def test_gaps_rank_and_score():
    ref = np.array([[3.0, 2.0, 1.0]])
    ok = harness.gaps(ref.astype(np.float32), np.array([[5, 6, 7]]), ref, ref)
    assert ok == {"rank_gap": 0.0, "score_err": 0.0}
    worse = harness.gaps(np.array([[3.0, 2.0, 0.5]], np.float32), np.array([[5, 6, 8]]),
                         ref, np.array([[3.0, 2.0, 0.5]]))
    assert worse["rank_gap"] == 0.5 and worse["score_err"] == 0.0
    lied = harness.gaps(np.array([[3.0, 2.0, 1.0]], np.float32), np.array([[5, 6, 8]]),
                        ref, np.array([[3.0, 2.0, 0.5]]))
    assert lied["score_err"] == 0.5
    missing = harness.gaps(np.array([[3.0, 2.0, -np.inf]], np.float32), np.array([[5, 6, -1]]),
                           ref, np.array([[3.0, 2.0, -np.inf]]))
    assert missing["rank_gap"] == np.inf


@pytest.mark.parametrize("name", ["full1m", "tiered4m"])
def test_control_fails_the_check(name):
    """The reference one precision lower (bfloat16 profiles for float32, an
    int4 sidecar for int8 and a bfloat16 re-rank) in the program's place fails
    the configuration's
    limits, at a size a test run holds."""
    with open(harness.PB / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg["lake"]["n_columns"] = 2048
    cfg["check"].update(sample=16)
    if "survivors" in cfg["plan"]:
        cfg["plan"].update(survivors=512, budget=512)     # the planner at 2048 columns
    out = control.control_numbers(cfg, 2 ** 32 + 3, "cpu", log=lambda s: None)
    limits = cfg["check"]["limits"]
    assert any(out[k] > limits[k] for k in ("rank_gap", "score_err")), out
