"""Profile feature layout shared by profiling, distance and predictor code.

The paper (Table II) selects ~20 meta-features out of 60. We keep exactly the
selected set, laid out as a fixed-width vector so profiles are dense device
tensors:

* ``numeric`` part: ``(C, F_NUM)`` float32 — z-score normalized lake-wide
  before comparison (paper: "Normalize = Yes" column; we z-score every
  numeric slot which subsumes the paper's subset).
* ``words`` part: ``(C, F_WORDS)`` uint32 — the 10 most frequent value
  hashes + the "first word" proxy (minimum value hash; the paper orders
  alphabetically, we order by stable hash).

The constants are those of ``repro.core.features``. Inside the port's torch
code a hash is a ``torch.int64`` holding the uint32 value; it is uint32
numpy at the package boundary and an int32 bit-view inside a kernel.
"""
from __future__ import annotations

# ---- numeric slots ---------------------------------------------------------
CARDINALITY = 0        # number of distinct values
UNIQUENESS = 1         # cardinality / n_valid_rows
ENTROPY = 2            # Shannon entropy of the value frequency distribution
MIN_FREQ = 3           # min frequency-distribution count
MAX_FREQ = 4           # max frequency-distribution count
MAX_PERC_FREQ = 5      # max frequency as a fraction of rows
SD_PERC_FREQ = 6       # stddev of frequency fractions
OCTILE_0 = 7           # 7 interior octiles (12.5% .. 87.5%) of the
OCTILE_LAST = 13       # frequency distribution, in fractions of rows
LONGEST_STR = 14       # characters in the longest value
SHORTEST_STR = 15      # characters in the shortest value
AVG_STR = 16           # mean characters per value
AVG_WORDS = 17         # mean words per value
MIN_WORDS = 18         # min words per value
MAX_WORDS = 19         # max words per value
SD_WORDS = 20          # stddev of words per value

F_NUM = 21

NUMERIC_NAMES = [
    "cardinality", "uniqueness", "entropy", "min_freq", "max_freq",
    "max_perc_freq", "sd_perc_freq",
    "octile_1", "octile_2", "octile_3", "octile_4", "octile_5", "octile_6",
    "octile_7",
    "longest_str", "shortest_str", "avg_str",
    "avg_words", "min_words", "max_words", "sd_words",
]
assert len(NUMERIC_NAMES) == F_NUM

# ---- word-hash slots -------------------------------------------------------
N_FREQ_WORDS = 10      # top-10 most frequent value hashes
FIRST_WORD = 10        # index of the first-word proxy inside ``words``
F_WORDS = N_FREQ_WORDS + 1

# ---- distance-vector layout (predictor input) ------------------------------
# 0..F_NUM-1   : |z(a_i) - z(b_i)| per numeric slot
# F_NUM        : frequent-word overlap   |top10(A) ∩ top10(B)| / 10
# F_NUM + 1    : first-word proxy equality (0/1)
D_WORD_OVERLAP = F_NUM
D_FIRST_WORD_EQ = F_NUM + 1
F_DIST = F_NUM + 2

DIST_NAMES = [f"d_{n}" for n in NUMERIC_NAMES] + ["word_overlap", "first_word_eq"]
assert len(DIST_NAMES) == F_DIST

# Sentinel used for invalid / padded cells inside the uint32 hash space.
# ``ingest`` remaps genuine hashes equal to the sentinel, so it is exact.
HASH_SENTINEL = 0xFFFFFFFF
