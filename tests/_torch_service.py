"""Shared pieces of the port's service tests: one model in both packages,
the tie-aware ranking comparator and small catalog helpers."""
import numpy as np

from repro.core.gbdt import GBDTParams as JGBDTParams
from repro.core.predictor import JoinQualityModel as JJoinQualityModel
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.predictor import JoinQualityModel

# the scorer tolerances of tests/test_kernels.py
RTOL, ATOL = 1e-4, 1e-5


def model_pair(model: JoinQualityModel):
    """A port model and the JAX package's model with the same trees."""
    g = model.gbdt
    jm = JJoinQualityModel(gbdt=JGBDTParams(feats=g.feats.copy(), thrs=g.thrs.copy(),
                                            leaves=g.leaves.copy(), base=g.base),
                           strictness=model.strictness, train_r2=model.train_r2)
    return model, jm


def tiny_model() -> JoinQualityModel:
    """One stump with zero leaves: every pair scores 0.0."""
    return JoinQualityModel(gbdt=GBDTParams(
        feats=np.zeros((1, 1), np.int32), thrs=np.zeros((1, 1), np.float32),
        leaves=np.zeros((1, 2), np.float32), base=0.0))


def cols(prefix: str, n: int = 40, start: int = 0):
    return [(f"{prefix}_x", [f"{prefix}v{i}" for i in range(start, start + n)])]


def str_table(cat, name, seed, n_cols=3, n_rows=240):
    rng = np.random.default_rng(seed)
    cat.add_table(name, [(f"{name}_c{j}",
                          [f"tok{rng.integers(0, 70)}" for _ in range(n_rows)])
                         for j in range(n_cols)])


def match_rows(responses):
    return [[(m.column_id, round(m.score, 5)) for m in r.matches] for r in responses]


def assert_same_ranking(s_ref, i_ref, s, i, tol=RTOL):
    """Ranked output equal up to the order of exact score ties (the
    comparator of tests/test_grid.py)."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s, i = np.asarray(s), np.asarray(i)
    assert s.shape == s_ref.shape and i.shape == i_ref.shape
    assert (np.isfinite(s) == np.isfinite(s_ref)).all()
    both = np.isfinite(s) & np.isfinite(s_ref)
    np.testing.assert_allclose(s[both], s_ref[both], rtol=tol, atol=ATOL)
    for row in range(s.shape[0]):
        a = {int(x) for x in i_ref[row] if x >= 0}
        b = {int(x) for x in i[row] if x >= 0}
        for ids, sc, other, diff in ((i_ref[row], s_ref[row], s[row], a - b),
                                     (i[row], s[row], s_ref[row], b - a)):
            for d in diff:
                sd = sc[list(ids).index(d)]
                near = np.min(np.abs(other[np.isfinite(other)] - sd))
                assert near <= tol * max(1.0, abs(sd)), (
                    f"row {row}: id {d} (score {sd}) has no tied score in the "
                    f"other ranking (closest {near})")


def responses_as_arrays(responses, k):
    """Engine responses -> (scores (Q, k), ids (Q, k)) padded with -inf/-1."""
    s = np.full((len(responses), k), -np.inf, np.float32)
    i = np.full((len(responses), k), -1, np.int64)
    for row, r in enumerate(responses):
        for col, m in enumerate(r.matches[:k]):
            s[row, col], i[row, col] = m.score, m.column_id
    return s, i


def assert_same_responses(want, got, k):
    """Both engines' responses: equal ids up to exact ties, equal
    ``n_candidates``, scores within the scorer tolerance."""
    assert [r.name for r in want] == [r.name for r in got]
    assert [r.n_candidates for r in want] == [r.n_candidates for r in got]
    assert_same_ranking(*responses_as_arrays(want, k), *responses_as_arrays(got, k))
