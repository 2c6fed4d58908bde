"""FREYJA's own distributed discovery step as a dry-runnable config: the
paper's query path (profile distances -> GBDT -> top-k) over a sharded
profile corpus. Not an LM; both packages' launch/dryrun.py use it as an
extra cell (``--arch freyja-discovery``)."""
N_COLUMNS = 16 * 1024 * 1024       # 16M columns (a very large lake)
N_QUERIES = 64
TOP_K = 100
