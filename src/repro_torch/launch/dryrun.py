"""Device-free dry run: build every (arch × shape × mesh) cell on ``meta``.

The port of ``repro.launch.dryrun``. Every device is ``torch.device("meta")``:
the device-free counterpart of the JAX package's 512 forced host devices,
not a fallback. A cell's parameters, AdamW moments, inputs and caches are
``meta`` tensors placed by the port's own shardings (``dist.sharding``), so
the dry run never allocates on the host or the card. Building them is the
coherence check that XLA's lowering gives the JAX package: ``NamedSharding``
refuses a spec that maps a mesh axis twice (``DuplicateSpecError``, as JAX
does, e.g. ZeRO-1 under ``fsdp``), and a cell the registry does not support
is skipped.

What each result key comes from, beside the JAX package's source:

* ``flops_per_device``, ``bytes_per_device``, ``collective_bytes_per_device``,
  ``cost_detail``, ``n_params``, ``n_active_params``, ``model_flops``,
  ``useful_flops_ratio``: the same analytic ``costmodel.cell_cost``; equal
  to the JAX package's exactly.
* ``t_*_s``, ``bottleneck``, ``bound_s``, ``roofline_fraction``:
  ``hlo_analysis.roofline_terms`` with the H100 SXM5's constants.
* ``memory.argument_bytes`` / ``memory.output_bytes`` (XLA's
  ``memory_analysis``): the sum over argument (output) leaves of the
  per-device shard shape (``NamedSharding.shard_shape``, rounded up) times
  the itemsize. Tokens and labels count 4 bytes an element and the caches'
  host-int ``len``/``offset``/``enc_len`` 4 bytes each, as the JAX
  package's int32 (the port holds int64 tokens and host ints). Donated
  parameters, moments and caches count as outputs, as XLA counts them; XLA
  also counts an 8-byte tuple-table entry an output leaf, which the port has
  no counterpart of. A prefill's logits are taken as split like the batch
  and the vocabulary (the lm head's spec); XLA chooses its own.
* ``memory.temp_bytes`` / ``memory.peak_bytes`` (XLA's buffer assignment):
  a live-bytes tracker (:class:`LiveBytes`, the ``meta`` storages alive)
  over the traced pieces below: ``temp_bytes`` is the largest transient of a
  piece (for a train cell plus the activations every block keeps for its
  backward pass), ``peak_bytes`` the argument bytes plus that. The card's
  cub and cuBLAS workspaces are not seen.
* ``traced_flops_per_device`` (XLA's ``cost_analysis`` flops, which count a
  ``While`` body once): ``torch.utils.flop_counter.FlopCounterMode`` over one
  data rank's step on ``meta``, tracing **one block of each kind** at the
  rank's shapes and multiplying by the block's count, plus the embedding and
  the head; a train cell's pieces run forward and backward (with block
  remat's recompute), times ``accum``. The sum is divided over the model
  axis (not in ``dp`` mode): the share of a device where the model axis
  splits the work, as XLA partitions it. (The port's single controller
  gathers a rank's weights and runs its whole step on one device.)
* XLA's ``bytes accessed`` is dropped: a ``meta`` trace knows no fusion, so
  no honest byte count exists.
* ``collectives``, ``collective_counts``, ``traced_collective_bytes_per_device``
  (XLA's HLO parse): ``dist.collectives.count_collectives`` over the same
  trace, scaled by the same counts: what the port's single-controller
  program moves for one data rank (it gathers each leaf where it is read),
  not XLA's schedule.
* ``compile_s`` / ``lower_s``: the trace's wall and the build's wall.

The discovery cell (``freyja-discovery``) takes its flops and bytes from
``costmodel.discovery_stage_costs`` and places what the port places: the
profiles, the word hashes as int64 (``repro_torch/device.py``; the JAX
package holds uint32), int64 column and table ids, and the ensemble.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import freyja_discovery as FD
from repro_torch.convert import _STACKED
from repro_torch.core import features as FT
from repro_torch.device import to_bits
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import axis_size, count_collectives
from repro_torch.exec import stages
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.costmodel import cell_cost, discovery_stage_costs
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import encdec, registry, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_norm, dtype_of, embed_tokens, lm_logits
from repro_torch.train.trainer import cross_entropy

ARTIFACT_DIR = "artifacts/dryrun_torch"
META = torch.device("meta")
# bytes an element the JAX package's argument counts take for the port's
# int64 tokens/labels and host-int cache scalars (int32 there)
TOKEN_BYTES = SCALAR_BYTES = 4
# the discovery cell's ensemble (the JAX cell's (50, 5) placeholder)
FREYJA_TREES, FREYJA_DEPTH = 50, 5


class SkipCell(Exception):
    pass


def make_mesh(mesh_kind: str, mesh_override: str | None = None) -> DeviceMesh:
    """The production mesh over ``meta`` devices, or a ``--mesh-override``
    grid ("data x model", with a leading pod axis of 2 for ``multi``)."""
    if not mesh_override:
        multi = mesh_kind == "multi"
        return make_production_mesh(multi_pod=multi, devices=[META] * (512 if multi else 256))
    dims = tuple(int(x) for x in mesh_override.split("x"))
    shape, axes = ((2,) + dims, ("pod", "data", "model")) if mesh_kind == "multi" \
        else (dims, ("data", "model"))
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [META] * devices.size
    return DeviceMesh(devices.reshape(shape), axes)


# ---------------------------------------------------------------------------
# sharding of inputs
# ---------------------------------------------------------------------------

def _n_batch(mesh) -> int:
    return axis_size(mesh, shd.batch_axes(mesh))


def _batch_spec(mesh, b: int, extra=()):
    ba = shd.batch_axes(mesh)
    nba = _n_batch(mesh)
    if b % nba == 0 and b >= nba:
        return shd.P(ba, *extra)
    return shd.P(None, *extra)


def cache_shardings(cfg: ArchConfig, caches, b: int, mesh):
    """Sharding for decode caches: batch-shard when divisible, else shard
    the sequence axis (flash-decoding style); kv-heads over 'model' when
    divisible, else the sequence over 'model'. Host-int scalars get P()."""
    ba = shd.batch_axes(mesh)
    nba = _n_batch(mesh)
    mp = mesh.shape.get("model", 1)
    batch_ok = b % nba == 0 and b >= nba

    def spec_for(name: str, leaf):
        if not torch.is_tensor(leaf) or leaf.dim() == 0:
            return shd.P()
        shape = leaf.shape
        axes = [None] * leaf.dim()
        if "kv/k" in name or "kv/v" in name or "cross/" in name:
            # (L, B, S, nk, dh[,or scales (L,B,S,nk)])
            if batch_ok:
                axes[1] = ba
            elif shape[2] % nba == 0:
                axes[2] = ba                      # sequence-sharded cache
            if shape[3] % mp == 0 and shape[3] >= mp:
                axes[3] = "model"                 # kv heads over model
            elif axes[2] is None and shape[2] % mp == 0 and shape[2] >= mp:
                axes[2] = "model"                 # else: sequence over model
        elif "mamba/ssm" in name:                 # (L, B, H, N, P)
            if batch_ok:
                axes[1] = ba
            if shape[2] % mp == 0:
                axes[2] = "model"
        elif "mamba/conv" in name:                # (L, B, K-1, C)
            if batch_ok:
                axes[1] = ba
            if shape[3] % mp == 0:
                axes[3] = "model"
        elif "rwkv" in name:
            if batch_ok:
                axes[1] = ba
        return shd.P(*axes)

    return _map_named(lambda name, leaf: shd.NamedSharding(mesh, spec_for(name, leaf)), caches)


def batch_shardings(cfg: ArchConfig, specs: dict, b: int, mesh) -> dict:
    out = {}
    for k, v in specs.items():
        if k == "caches":
            out[k] = cache_shardings(cfg, v, b, mesh)
        else:
            out[k] = shd.NamedSharding(mesh, _batch_spec(mesh, b, (None,) * (v.dim() - 1)))
    return out


def _map_named(fn, tree, prefix: str = ""):
    """``fn("a/b", leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def named_leaves(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested dict, paths joined by '/'."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _leaf_bytes(leaf, sharding) -> int:
    """Per-device bytes of one argument or output leaf."""
    if not torch.is_tensor(leaf):
        return SCALAR_BYTES                        # a host-int cache scalar
    size = TOKEN_BYTES if leaf.dtype == torch.int64 else leaf.element_size()
    return int(np.prod(sharding.shard_shape(leaf.shape), dtype=np.int64)) * size


def tree_bytes(tree, shardings) -> int:
    shards = dict(named_leaves(shardings))
    return sum(_leaf_bytes(leaf, shards[name]) for name, leaf in named_leaves(tree))


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One built cell: its config, its ``meta`` parameters (the module and
    their JAX-layout tree), shardings, inputs and moments."""
    cfg: ArchConfig
    kind: str
    batch: int
    seq: int
    mesh: DeviceMesh
    mode: str
    accum: int
    kv_bytes: int
    model: torch.nn.Module
    params: dict
    pshard: dict
    inputs: dict
    bshard: dict
    moments: dict | None = None
    mshard: dict | None = None


def build_cell(arch: str, shape_name: str, mesh, *, zero1: bool = True, accum: int = 1,
               kv_quant: bool = False, mode: str = "tp", moe_sharding: str | None = None,
               remat: str | None = None) -> Cell:
    """The cell's parameters, moments and inputs on ``meta`` with their
    shardings over ``mesh``. Raises ``SkipCell`` on unsupported cells and the
    sharding's own errors on incoherent ones."""
    shd.set_mode(mode)
    cfg = registry.get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if moe_sharding is not None and cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_sharding=moe_sharding)
    ok, reason = registry.cell_supported(cfg, shape_name)
    if not ok:
        raise SkipCell(reason)
    sh = registry.SHAPES[shape_name]
    b, kind = sh["batch"], sh["kind"]

    model = registry.init_params(cfg, device=META)
    params = shd.jax_layout(model, cfg)
    specs = registry.param_specs(cfg)
    pshard = shd.param_shardings(specs, mesh, params=params)
    inputs = registry.input_specs(cfg, shape_name)
    bshard = batch_shardings(cfg, inputs, b, mesh)
    cell = Cell(cfg=cfg, kind=kind, batch=b, seq=sh["seq"], mesh=mesh, mode=mode, accum=accum,
                kv_bytes=1 if kv_quant else 2, model=model, params=params, pshard=pshard,
                inputs=inputs, bshard=bshard)
    if kind == "train":
        if zero1:
            mshard = shd.zero1_shardings(specs, params, mesh)
        else:
            mshard = shd.param_shardings(specs, mesh)
        moments = _map_named(lambda _, p: torch.empty(p.shape, dtype=torch.float32,
                                                      device=META), params)
        cell.moments = {"m": moments, "v": moments,
                        "step": torch.empty((), dtype=torch.int32, device=META)}
        cell.mshard = {"m": mshard, "v": mshard,
                       "step": shd.NamedSharding(mesh, shd.P())}
    return cell


def memory_bytes(cell: Cell, read: set[str]) -> tuple[int, int]:
    """(argument bytes, output bytes) per device. ``read`` names the
    parameter leaves (JAX-layout paths) a prefill or decode step reads: the
    others are no arguments, as ``jax.jit`` prunes unused ones (whisper's
    encoder at decode). A train step reads them all (the update writes every
    leaf)."""
    cfg, mesh, b = cell.cfg, cell.mesh, cell.batch
    shards = dict(named_leaves(cell.pshard))
    params = sum(_leaf_bytes(leaf, shards[name]) for name, leaf in named_leaves(cell.params)
                 if cell.kind == "train" or name in read)
    inputs = tree_bytes(cell.inputs, cell.bshard)
    if cell.kind == "train":
        opt = tree_bytes(cell.moments, cell.mshard)
        # updated parameters and moments (donated), and the loss, grad norm, lr
        return params + opt + inputs, params + opt + 3 * 4
    if cell.kind == "prefill":
        logits = torch.empty((b, cell.seq, cfg.vocab), dtype=torch.float32, device=META)
        vocab = "model" if cfg.vocab % mesh.shape.get("model", 1) == 0 else None
        spec = _batch_spec(mesh, b, (None, vocab if cell.mode != "dp" else None))
        return params + inputs, _leaf_bytes(logits, shd.NamedSharding(mesh, spec))
    # decode: the next token and the (donated) caches
    tok = _leaf_bytes(cell.inputs["tokens"], cell.bshard["tokens"])
    caches = tree_bytes(cell.inputs["caches"], cell.bshard["caches"])
    return params + inputs, tok + caches


# ---------------------------------------------------------------------------
# the trace: flops, live bytes and collectives of one data rank's step
# ---------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops allocate inside the mode and that
    are still alive: ``live`` now, ``peak`` the most since the last
    :meth:`mark`. A storage is freed when the last tensor made inside the
    mode that holds it is; storages of tensors made outside (parameters,
    inputs, caches) are not counted, nor are views of them."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._storages: dict[int, list] = {}       # storage -> [tensors, bytes]
        self._tensors: set[int] = set()

    def mark(self) -> int:
        self.peak = self.live
        return self.live

    def _release(self, key: int, skey: int) -> None:
        self._tensors.discard(key)
        entry = self._storages[skey]
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[skey]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            if id(t) in self._tensors:
                continue
            skey = t.untyped_storage()._cdata
            if skey not in self._storages:
                if skey in inputs:
                    continue                       # a view of an outside tensor
                self._storages[skey] = [0, t.untyped_storage().nbytes()]
                self.live += self._storages[skey][1]
                self.peak = max(self.peak, self.live)
            self._storages[skey][0] += 1
            self._tensors.add(id(t))
            weakref.finalize(t, self._release, id(t), skey)
        return out


class MetaMemo(TorchDispatchMode):
    """Shape inference once a signature: an op on ``meta`` tensors that
    makes new tensors (its schema neither mutates nor aliases, and its first
    call returned no view of an input) is run once for each (op, argument
    shapes, strides, dtypes, other arguments); later calls get
    ``empty_strided`` results of the recorded shapes. A meta
    kernel costs the same whatever the tensor's size, and the models repeat
    the same few signatures (attention chunk pairs, the WKV token loop)
    thousands of times. The modes above it (the flop counter, the live-bytes
    tracker) still see every op."""

    def __init__(self):
        super().__init__()
        self._cache: dict = {}
        self._functional: dict = {}

    def _is_functional(self, func) -> bool:
        ok = self._functional.get(func)
        if ok is None:
            schema = func._schema
            ok = not schema.is_mutable and all(r.alias_info is None for r in schema.returns)
            self._functional[func] = ok
        return ok

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self._is_functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _signature(args), _signature(kwargs))
            hit = self._cache.get(key)
        except TypeError:                          # an unhashable argument
            return func(*args, **kwargs)
        if hit is None:
            out = func(*args, **kwargs)
            # an op may alias an input all the same (``_unsafe_view``)
            ins = {t.untyped_storage()._cdata for t in _tensors((args, kwargs))}
            aliased = any(t.untyped_storage()._cdata in ins for t in _tensors(out))
            self._cache[key] = _UNCACHED if aliased else _layout_of(out)
            return out
        return out_like(hit) if hit is not _UNCACHED else func(*args, **kwargs)


_UNCACHED = object()


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type, x.storage_offset())
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    hash(x)
    return x


def _layout_of(out):
    """What :func:`out_like` rebuilds ``out`` from, or ``_UNCACHED``."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype) \
            if out.device.type == "meta" else _UNCACHED
    if isinstance(out, (tuple, list)):
        parts = [_layout_of(v) for v in out]
        return _UNCACHED if any(p is _UNCACHED for p in parts) else (type(out), parts)
    return None if out is None else _UNCACHED


def out_like(layout):
    if layout is None:
        return None
    if layout[0] == "T":
        _, shape, stride, dtype = layout
        return torch.empty_strided(shape, stride, dtype=dtype, device=META)
    kind, parts = layout
    return kind(out_like(p) for p in parts)


def _tensors(x):
    """The tensors in an op's arguments or results (tuples, lists, dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _rank_rows(b: int, mesh) -> tuple[int, int | None]:
    """(rows a data rank takes, its index or None) for a batch of ``b``
    (``dist.sharding.rows_of``: every row on the first rank when they do not
    split)."""
    n = shd.n_data_ranks(mesh)
    return (b // n, 0) if b % n == 0 and b >= n else (b, None)


def _traced_names(model, cfg, whole: bool) -> list[str]:
    """The parameters a trace reads: all of them, or layer 0 of each stack."""
    names = [n for n, _ in model.named_parameters()]
    if whole:
        return names
    return [n for n in names if n.split(".")[0] not in _STACKED or n.split(".")[1] == "0"]


def _meta(shape, dtype, grad: bool = False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


def _pieces(cell: Cell, view, rows: int, mesh):
    """(count, run) for the step's pieces: the embedding, one block of each
    kind and the head, each ``run()`` returning the tensor the step carries
    on (a train piece's backward pass comes after, in :func:`trace_cell`)."""
    cfg, kind, s = cell.cfg, cell.kind, cell.seq
    cdt = dtype_of(cfg.compute_dtype)
    train = kind == "train"
    d = cfg.d_model
    toks = _meta((rows, 1 if kind == "decode" else s), torch.int64)
    x = _meta((rows, 1 if kind == "decode" else s, d), cdt, grad=train)

    def head():
        logits = lm_logits(view.embed, apply_norm(view.final_norm, x, cfg.norm))
        if train:
            return cross_entropy(logits, _meta((rows, s), torch.int64))
        return logits

    if kind == "decode":
        caches = registry.init_caches(cfg, rows, s, device=META)
        caches["len"] = s - 1                      # the step reads the whole cache
        pieces = [(1, lambda: embed_tokens(view.embed, toks, cdt))]
        if cfg.family in ("dense", "moe", "vlm"):
            pieces.append((cfg.n_layers, lambda: transformer.dense_decode_block(
                view.blocks[0], cfg, x, caches["kv"], 0, caches, mesh)))
        elif cfg.family == "ssm":
            pieces.append((cfg.n_layers, lambda: transformer.rwkv_decode_block(
                view.blocks[0], cfg, x, caches["rwkv"], 0)))
        elif cfg.family == "hybrid":
            pieces += [(cfg.n_layers, lambda: transformer.mamba_decode_block(
                view.blocks[0], view.blocks_norm[0], cfg, x, caches["mamba"], 0)),
                (len(transformer.hybrid_groups(cfg)),
                 lambda: transformer.shared_decode_block(view, cfg, x, caches["kv"], 0,
                                                         caches))]
        else:
            pieces.append((cfg.dec_layers, lambda: encdec.dec_decode_block(
                view.dec_blocks[0], cfg, x, 0, caches)))
        return pieces + [(1, head)]

    positions = torch.arange(s, device=META)[None].expand(rows, s)
    remat = transformer.remat
    if registry.is_encdec(cfg):
        memory = _meta((rows, s, d), cdt, grad=train)
        return [(cfg.enc_layers, lambda: remat(cfg, encdec._enc_block, view.enc_blocks[0],
                                               cfg, x, positions)),
                (1, lambda: apply_norm(view.enc_norm, memory, cfg.norm)),
                (1, lambda: embed_tokens(view.embed, toks, cdt)),
                (cfg.dec_layers, lambda: remat(cfg, encdec._dec_block, view.dec_blocks[0],
                                               cfg, x, positions, memory)),
                (1, head)]
    img = _meta((rows, cfg.n_patches, d), torch.bfloat16) if cfg.family == "vlm" else None
    pieces = [(1, lambda: transformer._embed_inputs(view, cfg, toks, img)[0])]
    if cfg.family in ("dense", "moe", "vlm"):
        pieces.append((cfg.n_layers, lambda: remat(
            cfg, transformer._dense_block_fwd, view.blocks[0], cfg, x, positions, mesh)))
    elif cfg.family == "ssm":
        pieces.append((cfg.n_layers, lambda: remat(
            cfg, transformer._rwkv_block, view.blocks[0], cfg, x)))
    else:
        pieces += [(cfg.n_layers, lambda: remat(
            cfg, transformer._mamba_block, view.blocks[0], view.blocks_norm[0], cfg, x)),
            (len(transformer.hybrid_groups(cfg)), lambda: remat(
                cfg, transformer._shared_block, view, cfg, x, positions))]
    return pieces + [(1, head)]


def _whole_step(cell: Cell, view, rows: int, mesh):
    """The model's own step function for one data rank, as one piece."""
    cfg, kind, s = cell.cfg, cell.kind, cell.seq
    batch = {"tokens": _meta((rows, 1 if kind == "decode" else s), torch.int64)}
    if kind == "decode":
        caches = registry.init_caches(cfg, rows, s, device=META)
        caches["len"] = s - 1
        return [(1, lambda: registry.decode_step(view, cfg, batch, caches,
                                                         mesh=mesh)[0])]
    if cfg.family == "vlm":
        batch["img"] = _meta((rows, cfg.n_patches, cfg.d_model), torch.bfloat16)
    if registry.is_encdec(cfg):
        batch["frames"] = _meta((rows, s, cfg.d_model), torch.bfloat16)
    if kind == "prefill":
        return [(1, lambda: registry.forward(view, cfg, batch, mesh=mesh))]
    labels = _meta((rows, s), torch.int64)
    return [(1, lambda: cross_entropy(registry.forward(view, cfg, batch, mesh=mesh),
                                              labels))]


def trace_cell(cell: Cell, *, whole: bool = False) -> dict:
    """Flops, live bytes and collectives of one data rank's step on
    ``meta``: one block of each kind times its count, plus the embedding and
    the head (``whole``: the model's own step function over every layer)."""
    cfg, mesh = cell.cfg, cell.mesh
    named = dict(cell.model.named_parameters())
    placed = shd.place_params({n: named[n] for n in _traced_names(cell.model, cfg, whole)},
                              cell.pshard, cfg)
    placed.leaves = _Reads(placed.leaves)
    train = cell.kind == "train"
    placed.requires_grad_(train)
    micro = cell.batch // cell.accum if train else cell.batch
    rows, index = _rank_rows(micro, mesh)
    view = placed.view(META, index)
    pieces = (_whole_step if whole else _pieces)(cell, view, rows, mesh)
    reps = cell.accum if train else 1
    flops = 0
    coll_bytes: dict[str, float] = {}
    coll_counts: dict[str, int] = {}
    kept = peak = 0
    with MetaMemo(), FlopCounterMode(display=False) as fc, LiveBytes() as live, \
            torch.set_grad_enabled(train):
        for count, run in pieces:
            f0 = fc.get_total_flops()
            start = live.mark()
            with count_collectives() as coll:
                out = run()
                after_fwd = live.live - start
                if train and out.requires_grad:
                    out.backward(torch.empty_like(out))
            del out
            n = count * reps
            flops += n * (fc.get_total_flops() - f0)
            for op, v in coll.bytes_by_op.items():
                coll_bytes[op] = coll_bytes.get(op, 0.0) + n * v
                coll_counts[op] = coll_counts.get(op, 0) + n * coll.count_by_op[op]
            if train:
                kept += count * after_fwd
            peak = max(peak, live.peak - start)
    mp = mesh.shape.get("model", 1) if cell.mode != "dp" else 1
    return {"flops": flops / mp, "temp_bytes": int(kept + peak),
            "collectives": coll_bytes, "collective_counts": coll_counts,
            "read": {_jax_path(n) for n in placed.leaves.read}}


class _Reads(dict):
    """A placed model's leaves that remember which were read."""

    def __init__(self, leaves: dict):
        super().__init__(leaves)
        self.read: set[str] = set()

    def __getitem__(self, name):
        self.read.add(name)
        return super().__getitem__(name)


def _jax_path(name: str) -> str:
    """A port parameter name -> its JAX-layout path (``blocks.3.attn.wq`` ->
    ``blocks/attn/wq``: the stacked leaf that holds it)."""
    parts = name.split(".")
    return "/".join([parts[0], *parts[2:]] if parts[0] in _STACKED else parts)


# ---------------------------------------------------------------------------
# analysis + driver
# ---------------------------------------------------------------------------

def analyze(cell: Cell, *, zero1: bool = True) -> dict:
    cfg, mesh = cell.cfg, cell.mesh
    n_dev = int(np.prod(list(mesh.shape.values())))
    t0 = time.time()
    traced = trace_cell(cell)
    compile_s = time.time() - t0
    args, outs = memory_bytes(cell, traced["read"])
    ac = cell_cost(cfg, cell.kind, cell.batch, cell.seq, dict(mesh.shape), zero1=zero1,
                   kv_cache_dtype_bytes=cell.kv_bytes, mode=cell.mode)
    terms = hlo.roofline_terms(ac.flops, ac.hbm_bytes, ac.coll_bytes)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    mult = 6 if cell.kind == "train" else 2
    model_flops = mult * n_active * tokens
    t_model = model_flops / n_dev / hlo.PEAK_FLOPS
    result = {
        "kind": cell.kind, "batch": cell.batch, "seq": cell.seq,
        "n_devices": n_dev, "mesh": dict(mesh.shape), "compile_s": compile_s,
        "memory": {"argument_bytes": args, "output_bytes": outs,
                   "temp_bytes": traced["temp_bytes"],
                   "peak_bytes": args + traced["temp_bytes"]},
        "traced_flops_per_device": traced["flops"],
        "traced_collective_bytes_per_device": sum(traced["collectives"].values()),
        "collectives": traced["collectives"],
        "collective_counts": traced["collective_counts"],
        "flops_per_device": ac.flops, "bytes_per_device": ac.hbm_bytes,
        "collective_bytes_per_device": ac.coll_bytes, "cost_detail": ac.detail,
        "n_params": n_params, "n_active_params": n_active, "model_flops": model_flops,
        "useful_flops_ratio": model_flops / (ac.flops * n_dev) if ac.flops else 0.0,
        "roofline_fraction": t_model / terms["bound_s"] if terms["bound_s"] else 0.0,
    }
    result.update(terms)
    return result


def analyze_freyja(mesh, *, bf16_profiles: bool = False) -> dict:
    """The paper's own distributed discovery query as a dry-run cell: the
    corpus and query shapes of ``configs.freyja_discovery``, the column axis
    over the batch axes (replicated over the others), the queries and the
    ensemble on every device, as the port places them
    (``exec.sharded.place_sharded_corpus``): float32 profiles (bfloat16 with
    ``bf16_profiles``), int64 word hashes and ids."""
    t0 = time.time()
    n, q, k = FD.N_COLUMNS, FD.N_QUERIES, FD.TOP_K
    zdt = torch.bfloat16 if bf16_profiles else torch.float32
    n_shards = _n_batch(mesh)
    corpus = {"z": (n, FT.F_NUM, zdt), "w": (n, FT.F_WORDS, torch.int64),
              "cids": (n, None, torch.int64), "tids": (n, None, torch.int64)}
    queries = {"zq": (q, FT.F_NUM, zdt), "wq": (q, FT.F_WORDS, torch.int64),
               "tq": (q, None, torch.int64), "qid": (q, None, torch.int64)}
    t, depth = FREYJA_TREES, FREYJA_DEPTH
    gbdt = {"feats": ((t, depth), torch.int32), "thrs": ((t, depth), torch.float32),
            "leaves": ((t, 1 << depth), torch.float32)}

    def nbytes(shape, dtype):
        return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()

    per = -(-n // n_shards)
    args = sum(nbytes((per,) + ((f,) if f else ()), dt) for _, f, dt in corpus.values())
    args += sum(nbytes((rows,) + ((f,) if f else ()), dt) for rows, f, dt in queries.values())
    args += sum(nbytes(shape, dt) for shape, dt in gbdt.values())
    out = 2 * nbytes((q, k), torch.float32) + nbytes((q,), torch.int64)   # scores, ids, n_scored

    # one tile's transient, as the port's ``all`` tile allocates it. This
    # mirrors the ``candidates == "all"`` branch of ``tile`` inside
    # ``exec.sharded.build_sharded_pipeline``: ``stages.score_columns``
    # (the word-hash bit-views ``ops.fused_score`` makes and its (Q, C_l)
    # scores, stood in for here: the kernel has no meta version), then the
    # exclusion mask and ``stages.merge_topk``, which run as they are: on
    # meta its top-k allocates the kernel's positions and scratch from the
    # kernel's own plan (``kernels.topk.topk_meta``). A change to that
    # branch must be made here too.
    live = LiveBytes()
    with live:
        z = _meta((per, FT.F_NUM), zdt)
        w, cids, tids = (_meta((per, FT.F_WORDS), torch.int64), _meta((per,), torch.int64),
                         _meta((per,), torch.int64))
        tq, qid = _meta((q,), torch.int64), _meta((q,), torch.int64)
        start = live.mark()
        bits = (to_bits(_meta((q, FT.F_WORDS), torch.int64)), to_bits(w))
        s = _meta((q, z.shape[0]), torch.float32)
        s = torch.where(stages.exclusion_mask(cids, tids, tq, qid), float("-inf"), s)
        stages.merge_topk(s, cids, k)
        del bits, s
        temp = live.peak - start
    cost = discovery_stage_costs(q, n, budget=n, candidates="all", k=k, n_trees=t,
                                 tree_depth=depth, n_shards=n_shards)
    result = {"kind": "discover", "batch": q, "seq": n,
              "n_devices": int(np.prod(list(mesh.shape.values()))), "mesh": dict(mesh.shape),
              "compile_s": time.time() - t0,
              "memory": {"argument_bytes": args, "output_bytes": out, "temp_bytes": temp,
                         "peak_bytes": args + temp},
              "flops_per_device": cost["total_flops"],
              "bytes_per_device": cost["total_hbm_bytes"],
              "collective_bytes_per_device": cost["total_collective_bytes"],
              "cost_detail": cost}
    result.update(hlo.roofline_terms(cost["total_flops"], cost["total_hbm_bytes"],
                                     cost["total_collective_bytes"]))
    return result


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, zero1=True, accum=1,
             out_dir: str = ARTIFACT_DIR, tag: str = "", kv_quant: bool = False,
             mode: str = "tp", moe_sharding: str | None = None,
             mesh_override: str | None = None, freyja_bf16: bool = False,
             remat: str | None = None) -> dict:
    """Build, analyse and write one cell's JSON. The sharding mode is
    restored afterwards."""
    mesh = make_mesh(mesh_kind, mesh_override)
    mode_before = shd.get_mode()
    t0 = time.time()
    try:
        if arch == "freyja-discovery":
            lower_s = 0.0
            result = analyze_freyja(mesh, bf16_profiles=freyja_bf16)
        else:
            cell = build_cell(arch, shape_name, mesh, zero1=zero1, accum=accum,
                              kv_quant=kv_quant, mode=mode, moe_sharding=moe_sharding,
                              remat=remat)
            lower_s = time.time() - t0
            result = analyze(cell, zero1=zero1)
        result.update(arch=arch, shape=shape_name, mesh_kind=mesh_kind, lower_s=lower_s,
                      status="ok",
                      variant={"kv_quant": kv_quant, "mode": mode, "zero1": zero1,
                               "accum": accum, "moe_sharding": moe_sharding,
                               "mesh_override": mesh_override, "freyja_bf16": freyja_bf16})
    except SkipCell as e:
        result = {"arch": arch, "shape": shape_name, "mesh_kind": mesh_kind,
                  "status": "skip", "reason": str(e)}
    except Exception as e:
        result = {"arch": arch, "shape": shape_name, "mesh_kind": mesh_kind,
                  "status": "error", "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
    finally:
        shd.set_mode(mode_before)
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--sharding-mode", default="tp", choices=["tp", "fsdp", "dp"])
    ap.add_argument("--moe-sharding", default=None, choices=[None, "tp", "ep"])
    ap.add_argument("--mesh-override", default=None,
                    help="e.g. 64x4 — same chip count, different data×model split")
    ap.add_argument("--freyja-bf16", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "block", "none"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in registry.list_archs() for s in registry.SHAPES]
        cells.append(("freyja-discovery", "query"))
    else:
        shape = args.shape
        if shape is None and args.arch == "freyja-discovery":
            shape = "query"              # the discovery cell's only shape
        cells = [(args.arch, shape)]

    results = []
    for mk in meshes:
        for arch, shape in cells:
            t0 = time.time()
            r = run_cell(arch, shape, mk, zero1=not args.no_zero1, accum=args.accum,
                         out_dir=args.out_dir, tag=args.tag, kv_quant=args.kv_quant,
                         mode=args.sharding_mode, moe_sharding=args.moe_sharding,
                         mesh_override=args.mesh_override, freyja_bf16=args.freyja_bf16,
                         remat=args.remat)
            status = r["status"]
            if status == "ok":
                extra = (f"bottleneck={r['bottleneck']} "
                         f"t=({r['t_compute_s']:.3f},{r['t_memory_s']:.3f},"
                         f"{r['t_collective_s']:.3f})s")
            elif status == "skip":
                extra = r["reason"]
            else:
                extra = r["error"][:160]
            print(f"[{mk:6s}] {arch:22s} {str(shape):11s} {status:5s} "
                  f"{time.time() - t0:6.1f}s {extra}", flush=True)
            results.append(r)
    return results


if __name__ == "__main__":
    main()
