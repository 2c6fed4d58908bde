"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
runs one cell of ``BENCHMARK.json`` once (``perfbench/run.py``)."""
import os
import sys

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if _SRC not in sys.path:
    sys.path.insert(1, _SRC)
