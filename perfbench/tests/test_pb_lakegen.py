"""The benchmark's lake generator: planted tiers, disjoint noise, the hash
arithmetic, and the same lake from the same seed."""
import itertools

import numpy as np
import pytest
import torch

from perfbench import lakegen

SHAPE = lakegen.LakeShape(n_columns=4096)


def _np_splitmix64(x):
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def test_hash_arithmetic_matches_unsigned_numpy():
    x = np.random.default_rng(0).integers(0, 2 ** 62, size=4096, dtype=np.uint64)
    x[:3] = [0, 1, 2 ** 62 - 1]
    want = _np_splitmix64(x)
    got = lakegen.splitmix64(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy().view(np.uint64), want)
    for m in (2, 9, 13):
        assert np.array_equal(lakegen.umod(got, m).numpy(), (want % np.uint64(m)).astype(np.int64))
    f = ((want >> np.uint64(32)) ^ (want & np.uint64(0xFFFFFFFF))).astype(np.int64)
    f[f == 0xFFFFFFFF] = 0xFFFFFFFE
    assert np.array_equal(lakegen.fold32(got).numpy(), f)
    bits = lakegen.to_bits(torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE]))
    assert bits.numpy().view(np.uint32).tolist() == [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE]


def _host(seed, chunk=512):
    """The three fields as ingest reads them: chunk by chunk, crossing the
    1000-column blocks."""
    lake = lakegen.StreamedLake(SHAPE, seed, "cpu", block=1000)
    parts = [(lake.values32[lo:lo + chunk], lake.char_len[lo:lo + chunk],
              lake.word_cnt[lo:lo + chunk]) for lo in range(0, SHAPE.n_columns, chunk)]
    assert lake.values32.shape == (SHAPE.n_columns, SHAPE.row_budget)
    with pytest.raises(ValueError, match="in order"):
        lake.values32[0:10]
    return tuple(np.concatenate(p) for p in zip(*parts))


@pytest.fixture(scope="module")
def lake():
    return _host(2 ** 33 + 5)


def test_same_seed_same_lake_and_blocks_agree(lake):
    again = _host(2 ** 33 + 5, chunk=1000)
    for a, b in zip(lake, again):
        assert np.array_equal(a, b)
    other = _host(6)
    assert not np.array_equal(lake[0], other[0])
    blocks = list(lakegen.generate_blocks(SHAPE, 2 ** 33 + 5, "cpu", 1000))
    v = torch.cat([b[2] for b in blocks])
    assert np.array_equal(lakegen.to_bits(v).numpy().view(np.uint32), lake[0])


def test_planted_tiers_and_disjoint_noise(lake):
    values = lake[0]
    cols = torch.arange(SHAPE.n_columns)
    group, tier = SHAPE.group(cols).numpy(), SHAPE.tier(cols).numpy()
    sets = [set(row.tolist()) for row in values]
    for t, j in enumerate(SHAPE.jaccard_tiers):
        s = lakegen.support_size(j, SHAPE.vocab_size)
        members = np.flatnonzero(tier == t)
        # every support value appears: a member's value set is its support
        assert all(len(sets[i]) == s for i in members)
        jac = []
        for g in np.unique(group[members])[:6]:
            m = np.flatnonzero(group == g)
            assert len(m) == SHAPE.group_size
            # striped: members sit n_groups columns apart, in different tables
            assert len(set((m // SHAPE.cols_per_table).tolist())) == len(m)
            jac += [len(sets[a] & sets[b]) / len(sets[a] | sets[b])
                    for a, b in itertools.combinations(m, 2)]
        assert abs(np.mean(jac) - j) < 0.06, (j, np.mean(jac))
    noise = np.flatnonzero(group < 0)
    assert noise.size == SHAPE.n_columns - SHAPE.n_groups * SHAPE.group_size
    assert all(len(sets[i]) == SHAPE.row_budget for i in noise[:50])
    pool = set().union(*(sets[i] for i in noise[:200]))
    assert len(pool) == 200 * SHAPE.row_budget          # pairwise disjoint
    assert not pool & set().union(*(sets[i] for i in np.flatnonzero(group >= 0)[:200]))
    cl, wc = lake[1], lake[2]
    assert cl.min() >= 4 and cl.max() <= 4 + 12 + 10 and wc.min() >= 1 and wc.max() <= 4
