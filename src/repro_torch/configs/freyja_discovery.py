"""FREYJA's own distributed discovery step as a dry-runnable config: the
paper's query path (profile distances -> GBDT -> top-k) over a sharded
profile corpus. Not an LM; the JAX package's launch/dryrun.py uses it as an
extra cell (the port's dry run is still to come)."""
N_COLUMNS = 16 * 1024 * 1024       # 16M columns (a very large lake)
N_QUERIES = 64
TOP_K = 100
