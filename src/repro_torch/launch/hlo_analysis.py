"""Collective bytes and roofline terms for the dry run.

The port of ``repro.launch.hlo_analysis``, under the same name so a reader
finds the counterpart. The JAX package parses the compiled HLO text for its
collectives; the port compiles no HLO, so it has no text to parse
(``parse_collectives`` is not ported). What it keeps:

* :class:`CollectiveStats`, unchanged, and
* :func:`collective_bytes`, both defined in ``dist.collectives`` (whose
  ledger applies them at run time, below this layer) and re-exported
  here. ``collective_bytes`` holds the ring-algorithm factors the JAX parser
  applies to each collective it finds, as a function of one op. The bytes
  a device sends for a group of ``n``:

      all-gather          result_bytes  × (n-1)/n
      reduce-scatter      operand_bytes × (n-1)/n
      all-reduce          2 × operand_bytes × (n-1)/n   (RS + AG phases)
      all-to-all          operand_bytes × (n-1)/n
      collective-permute  operand_bytes

  with ``n`` raised to at least 2, as the parser does.
  ``dist.collectives.count_collectives`` applies it to the port's own
  collectives as they run;
* :func:`roofline_terms`, with the constants of the card the port runs on.
"""
from __future__ import annotations

from repro_torch.dist.collectives import CollectiveStats, collective_bytes

__all__ = ["CollectiveStats", "collective_bytes", "roofline_terms",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]


# ---- NVIDIA H100 SXM5 80GB constants (roofline denominators) --------------
PEAK_FLOPS = 989.4e12        # dense bf16 FLOP/s, H100 SXM5 80GB data sheet (700 W)
HBM_BW = 3.35e12             # HBM3 bytes/s, H100 SXM5 80GB data sheet
# per-GPU inter-node bytes/s: one 400 Gb/s NDR InfiniBand HCA a GPU, since a
# 256-card mesh spans 32 eight-card nodes
LINK_BW = 50e9


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    t_c = flops_per_dev / PEAK_FLOPS
    t_m = bytes_per_dev / HBM_BW
    t_x = coll_bytes_per_dev / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_x,
            "bottleneck": dom,
            "bound_s": max(t_c, t_m, t_x)}
