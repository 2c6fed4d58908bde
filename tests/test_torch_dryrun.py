"""The port's dry run against the JAX package's: the LM cost model exactly,
``input_specs``, the input and cache shardings and every leaf's per-device
shard shape on both production meshes, the test cell's JSON
(``tests/test_distributed.py::test_dryrun_cell_small``'s whisper-base
``decode_32k`` cell), the block-times-count flop trace against a
whole-model trace, ``init_params`` on ``meta``, the collective ledger and
each cell's status.

The JAX side that needs the 512 forced host devices (the shardings, shard
shapes and the compiled test cell) runs once per module, in one subprocess
(``repro.launch.dryrun`` sets ``XLA_FLAGS`` on import, before JAX
initialises). The cost model and ``cell_supported`` are plain numpy and
run in this process.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro.launch.costmodel as jcost
import repro.launch.hlo_analysis as jhlo
from repro.models import registry as jreg
from repro_torch.dist import sharding as shd
from repro_torch.dist import collectives
from repro_torch.dist.collectives import (all_to_all, count_collectives, gather, place,
                                         psum)
from repro_torch.launch import costmodel as tcost
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as thlo
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import registry as treg

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = jreg.list_archs()
SHAPES = list(jreg.SHAPES)
MESH_SHAPES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
MODES = ("tp", "fsdp", "dp")
# the JAX dry run's figures for the test cell (PYTHONPATH=src python -m
# repro.launch.dryrun --arch whisper-base --shape decode_32k --mesh single)
TEST_CELL_ARGUMENT_BYTES = 408_764_460
ANALYTIC_KEYS = ("n_devices", "mesh", "flops_per_device", "bytes_per_device",
                 "collective_bytes_per_device", "cost_detail", "n_params",
                 "n_active_params", "model_flops", "useful_flops_ratio", "kind", "batch",
                 "seq", "status")
# block-times-count against the whole-model trace
FLOPS_RTOL = 1e-9


@pytest.fixture(autouse=True)
def tp_mode():
    """Every test starts and ends in the default mode (a process global)."""
    shd.set_mode("tp")
    yield
    shd.set_mode("tp")


_JAX_SIDE = r"""
import json, sys
import repro.launch.dryrun as D               # forces 512 host devices
import jax
from repro.dist import sharding as shd
from repro.launch.mesh import make_production_mesh
from repro.models import registry

def entry(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else list(e)
    return e

def spec(s):
    return [entry(e) for e in s.spec]

def shard(s, shape):
    try:
        return list(s.shard_shape(shape))
    except ValueError:                        # uneven: XLA pads to the ceiling
        out = []
        sp = tuple(s.spec) + (None,) * (len(shape) - len(s.spec))
        for d, e in zip(shape, sp):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n = 1
            for a in axes:
                n *= s.mesh.shape[a]
            out.append(-(-d // n))
        return out

def flat(tree):
    return [("/".join(str(getattr(k, "key", k)) for k in p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]

out = {"specs": {}, "inputs": {}, "params": {}}
meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}
for arch in registry.list_archs():
    cfg = registry.get_config(arch)
    psds, lspecs = D._params_sds(cfg)
    for mk, mesh in meshes.items():
        rec = {}
        for mode in ("tp", "fsdp", "dp"):
            shd.set_mode(mode)
            ps = shd.param_shardings(lspecs, mesh, params=psds)
            rec[mode] = {n: shard(s, l.shape) for (n, l), (_, s) in zip(flat(psds), flat(ps))}
            try:
                ms = shd.zero1_shardings(lspecs, psds, mesh)
                rec[mode + "_zero1"] = {n: shard(s, l.shape)
                                        for (n, l), (_, s) in zip(flat(psds), flat(ms))}
            except Exception as e:
                rec[mode + "_zero1"] = type(e).__name__
            raw = shd.param_shardings(lspecs, mesh)
            rec[mode + "_raw"] = {n: shard(s, l.shape)
                                  for (n, l), (_, s) in zip(flat(psds), flat(raw))}
        shd.set_mode("tp")
        out["params"][f"{arch}|{mk}"] = rec
    for shape in registry.SHAPES:
        if not registry.cell_supported(cfg, shape)[0]:
            continue
        ins = registry.input_specs(cfg, shape)
        out["inputs"][f"{arch}|{shape}"] = {n: [list(l.shape), str(l.dtype)] for n, l in flat(ins)}
        b = registry.SHAPES[shape]["batch"]
        for mk, mesh in meshes.items():
            bs = D.batch_shardings(cfg, ins, b, mesh)
            out["specs"][f"{arch}|{shape}|{mk}"] = {
                n: [spec(s), shard(s, l.shape)] for (n, l), (_, s) in zip(flat(ins), flat(bs))}
r = D.run_cell("whisper-base", "decode_32k", "single", out_dir=sys.argv[1], tag="_ref")
out["cell"] = {k: v for k, v in r.items() if k != "traceback"}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's shardings, shard shapes, input specs and compiled
    test cell, from one subprocess with 512 forced host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_SIDE,
                          str(tmp_path_factory.mktemp("jax_dryrun"))],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=560)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _spec(s) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


# ---------------------------------------------------------------------------
# the analytic cost model, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_equals_the_jax_package_exactly(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    n = 0
    for shape in SHAPES:
        sh = jreg.SHAPES[shape]
        for mesh_shape in MESH_SHAPES.values():
            for mode in MODES:
                for zero1 in (True, False):
                    for kv in (2, 1):
                        want = jcost.cell_cost(jcfg, sh["kind"], sh["batch"], sh["seq"],
                                               mesh_shape, zero1=zero1,
                                               kv_cache_dtype_bytes=kv, mode=mode)
                        got = tcost.cell_cost(tcfg, sh["kind"], sh["batch"], sh["seq"],
                                              mesh_shape, zero1=zero1,
                                              kv_cache_dtype_bytes=kv, mode=mode)
                        assert got.as_dict() == want.as_dict(), (shape, mesh_shape, mode)
                        n += 1
            for kv in (2, 1):
                assert tcost._cache_bytes_per_dev(tcfg, sh["batch"], sh["seq"], mesh_shape,
                                                  kv) == jcost._cache_bytes_per_dev(
                    jcfg, sh["batch"], sh["seq"], mesh_shape, kv)
        assert tcost.w_avg_decode(tcfg, sh["seq"]) == jcost.w_avg_decode(jcfg, sh["seq"])
    assert n == len(SHAPES) * 2 * 3 * 2 * 2
    # the six helpers the cell cost is built of, on their own
    for fn in ("_dense_layer_matmul_params", "_layer_active_params", "_layer_stored_params",
               "_n_layers", "_ssm_flops_per_token"):
        assert getattr(tcost, fn)(tcfg) == getattr(jcost, fn)(jcfg), fn
    for s in (1, 4096, 524288):
        assert tcost._attn_window(tcfg, s) == jcost._attn_window(jcfg, s)


def test_roofline_terms_use_the_h100_constants(monkeypatch):
    """The port's terms are JAX's formula with the H100 SXM5's numbers."""
    monkeypatch.setattr(jhlo, "PEAK_FLOPS", 989.4e12)
    monkeypatch.setattr(jhlo, "HBM_BW", 3.35e12)
    monkeypatch.setattr(jhlo, "ICI_BW", 50e9)
    for args in ((1e12, 1e9, 1e6), (1.0, 1e13, 0.0), (0.0, 0.0, 1e11)):
        assert thlo.roofline_terms(*args) == jhlo.roofline_terms(*args)
    src = open(thlo.__file__).read()
    assert "197e12" not in src and "819e9" not in src


@pytest.mark.parametrize("op,operand,result,n,want", [
    ("all-gather", 0, 1600, 16, 1500.0), ("reduce-scatter", 1600, 0, 16, 1500.0),
    ("all-reduce", 1600, 0, 16, 3000.0), ("all-to-all", 1600, 0, 4, 1200.0),
    ("collective-permute", 1600, 0, 4, 1600.0), ("all-reduce", 100, 0, 1, 100.0)])
def test_collective_bytes_are_the_ring_factors(op, operand, result, n, want):
    assert thlo.collective_bytes(op, operand, result, n) == want


# ---------------------------------------------------------------------------
# input specs, shardings and shard shapes against the JAX package
# ---------------------------------------------------------------------------

def _port_dtype(path: str, leaf) -> str:
    """The JAX dtype the port's leaf stands for: int64 tokens and labels for
    int32, host-int cache scalars for int32 scalars."""
    if not torch.is_tensor(leaf):
        return "int32"
    if leaf.dtype == torch.int64:
        return "int32"
    return str(leaf.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_jax_package(jax_side, arch):
    cfg = treg.get_config(arch)
    for shape in SHAPES:
        key = f"{arch}|{shape}"
        if not treg.cell_supported(cfg, shape)[0]:
            assert key not in jax_side["inputs"]
            continue
        specs = treg.input_specs(cfg, shape)
        got = {n: [list(leaf.shape) if torch.is_tensor(leaf) else [], _port_dtype(n, leaf)]
               for n, leaf in dryrun.named_leaves(specs)}
        assert got == jax_side["inputs"][key], key
        for n, leaf in dryrun.named_leaves(specs):
            if torch.is_tensor(leaf):
                assert leaf.device.type == "meta", n
                if n in ("tokens", "labels"):
                    assert leaf.dtype == torch.int64


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_shardings_match_the_jax_package(jax_side, arch):
    """batch_shardings / cache_shardings give JAX's PartitionSpec and shard
    shape for every leaf of every cell on both production meshes."""
    cfg = treg.get_config(arch)
    for mk in MESH_SHAPES:
        mesh = dryrun.make_mesh(mk)
        for shape in SHAPES:
            if not treg.cell_supported(cfg, shape)[0]:
                continue
            specs = treg.input_specs(cfg, shape)
            sh = dryrun.batch_shardings(cfg, specs, treg.SHAPES[shape]["batch"], mesh)
            shards = dict(dryrun.named_leaves(sh))
            got = {n: [_spec(shards[n]), list(shards[n].shard_shape(
                leaf.shape if torch.is_tensor(leaf) else ()))]
                for n, leaf in dryrun.named_leaves(specs)}
            assert got == jax_side["specs"][f"{arch}|{shape}|{mk}"], (shape, mk)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_and_moment_shard_shapes_match_the_jax_package(jax_side, arch):
    """Every parameter leaf (tp, fsdp, dp; with and without the divisibility
    fallback) and ZeRO-1 moment leaf has JAX's per-device shard shape on both
    production meshes; where JAX refuses the ZeRO-1 specs, so does the port,
    with the same exception class."""
    cfg = treg.get_config(arch)
    model = treg.init_params(cfg, device="meta")
    params = shd.jax_layout(model, cfg)
    specs = treg.param_specs(cfg)
    leaves = dict(dryrun.named_leaves(params))
    for mk in MESH_SHAPES:
        mesh = dryrun.make_mesh(mk)
        want = jax_side["params"][f"{arch}|{mk}"]
        for mode in MODES:
            shd.set_mode(mode)

            def shapes(tree):
                return {n: list(s.shard_shape(leaves[n].shape))
                        for n, s in dryrun.named_leaves(tree)}

            assert shapes(shd.param_shardings(specs, mesh, params=params)) == want[mode]
            assert shapes(shd.param_shardings(specs, mesh)) == want[mode + "_raw"]
            try:
                got = shapes(shd.zero1_shardings(specs, params, mesh))
            except Exception as e:
                got = type(e).__name__
            assert got == want[mode + "_zero1"], (mk, mode)
    shd.set_mode("tp")


# ---------------------------------------------------------------------------
# the test cell, end to end
# ---------------------------------------------------------------------------

def test_test_cell_json_equals_the_jax_dry_run(jax_side, tmp_path, monkeypatch):
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "single",
                 "--tag", "_test", "--out-dir", str(tmp_path)])
    got = json.loads((tmp_path / "whisper-base__decode_32k__single_test.json").read_text())
    want = jax_side["cell"]
    for key in ANALYTIC_KEYS:
        assert got[key] == want[key], key
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"] \
        == TEST_CELL_ARGUMENT_BYTES
    # outputs: the next token and the donated caches; XLA adds an 8-byte
    # tuple-table entry for each of the 8 output leaves
    assert got["memory"]["output_bytes"] + 8 * 8 == want["memory"]["output_bytes"]
    assert got["memory"]["peak_bytes"] == (got["memory"]["argument_bytes"]
                                           + got["memory"]["temp_bytes"])
    assert got["traced_flops_per_device"] > 0
    assert set(got["collectives"]) == {"all-gather"}       # tp gathers every weight read
    monkeypatch.setattr(jhlo, "PEAK_FLOPS", 989.4e12)
    monkeypatch.setattr(jhlo, "HBM_BW", 3.35e12)
    monkeypatch.setattr(jhlo, "ICI_BW", 50e9)
    terms = jhlo.roofline_terms(want["flops_per_device"], want["bytes_per_device"],
                                want["collective_bytes_per_device"])
    for key, value in terms.items():
        assert got[key] == value, key
    assert got["roofline_fraction"] == (want["model_flops"] / 256 / 989.4e12
                                        / terms["bound_s"])
    assert "xla_bytes_per_device" not in got


# short train and prefill shapes, so the whole-model trace is cheap; the
# vlm's image replaces its first 576 tokens, so its sequence is longer
SHORT_SHAPES = {"train_256": {"seq": 256, "batch": 32, "kind": "train"},
                "prefill_256": {"seq": 256, "batch": 32, "kind": "prefill"},
                "train_1k": {"seq": 1024, "batch": 32, "kind": "train"}}


@pytest.mark.parametrize("arch,shape", [("whisper-base", "decode_32k"),
                                        ("zamba2-2.7b", "decode_32k"),
                                        ("whisper-base", "train_256"),
                                        ("whisper-base", "prefill_256"),
                                        ("zamba2-2.7b", "train_256"),
                                        ("phi3.5-moe-42b-a6.6b", "prefill_256"),
                                        ("phi-3-vision-4.2b", "train_1k")])
def test_block_times_count_equals_the_whole_model_trace(arch, shape, monkeypatch):
    """The pieces (embedding, one block of each kind times its count, head;
    a train piece's backward and remat recompute) against the model's own
    step over every layer: the encoder-decoder's encoder and cross memory,
    the hybrid's shared groups, the MoE's dispatch and the vlm's image
    embedding included."""
    if shape in SHORT_SHAPES:
        monkeypatch.setitem(treg.SHAPES, shape, SHORT_SHAPES[shape])
    cell = dryrun.build_cell(arch, shape, dryrun.make_mesh("single"))
    pieces = dryrun.trace_cell(cell)
    whole = dryrun.trace_cell(cell, whole=True)
    assert pieces["flops"] > 0
    assert abs(pieces["flops"] - whole["flops"]) <= FLOPS_RTOL * whole["flops"]
    assert pieces["collective_counts"] == whole["collective_counts"]
    assert pieces["collectives"] == pytest.approx(whole["collectives"], rel=FLOPS_RTOL)
    assert pieces["read"] == whole["read"]


@pytest.mark.parametrize("arch,shape", [("whisper-base", "decode_32k"),
                                        ("smollm-360m", "train_4k")])
def test_the_shape_memo_changes_no_figure(arch, shape, monkeypatch):
    """MetaMemo only saves shape inference: flops, live bytes, collectives
    and the leaves read are those of the trace without it."""
    cell = dryrun.build_cell(arch, shape, dryrun.make_mesh("single"))
    memo = dryrun.trace_cell(cell)
    monkeypatch.setattr(dryrun, "MetaMemo", contextlib.nullcontext)
    assert dryrun.trace_cell(cell) == memo


def test_the_discovery_cell_places_what_the_port_places(tmp_path):
    """The discovery cell's arguments are the JAX cell's shapes with the
    port's int64 word hashes and ids (JAX: uint32 and int32) and the
    ensemble it places beside them."""
    r = dryrun.run_cell("freyja-discovery", "query", "single", out_dir=str(tmp_path),
                        mesh_override="4x1")
    assert r["status"] == "ok"
    n, q = 16 * 1024 * 1024 // 4, 64
    jax_args = n * (21 * 4 + 11 * 4 + 4 + 4) + q * (21 * 4 + 11 * 4 + 4 + 4)
    widened = (n + q) * (11 + 2) * 4              # uint32 / int32 -> int64
    ensemble = 50 * 5 * 4 + 50 * 5 * 4 + 50 * 32 * 4
    assert r["memory"]["argument_bytes"] == jax_args + widened + ensemble
    assert r["mesh"] == {"data": 4, "model": 1}
    assert r["flops_per_device"] == tcost.discovery_stage_costs(
        64, 16 * 1024 * 1024, budget=16 * 1024 * 1024, candidates="all", k=100, n_trees=50,
        tree_depth=5, n_shards=4)["total_flops"]
    # the scores and the bit-views of one tile at least
    assert r["memory"]["temp_bytes"] >= q * n * 4 + n * 11 * 4


# ---------------------------------------------------------------------------
# cells: status, errors, meta parameters
# ---------------------------------------------------------------------------

_NO_TRACE = {"flops": 0.0, "temp_bytes": 0, "collectives": {}, "collective_counts": {},
             "read": set()}


@pytest.mark.parametrize("arch", ARCHS)
def test_single_mesh_status_follows_cell_supported(arch, tmp_path, monkeypatch):
    """Every cell builds, or skips where JAX's ``cell_supported`` skips (the
    trace, timed in the --all run, is stubbed here)."""
    monkeypatch.setattr(dryrun, "trace_cell", lambda cell: _NO_TRACE)
    jcfg = jreg.get_config(arch)
    for shape in SHAPES:
        r = dryrun.run_cell(arch, shape, "single", out_dir=str(tmp_path))
        want = "ok" if jreg.cell_supported(jcfg, shape)[0] else "skip"
        assert r["status"] == want, (shape, r.get("error"))
        assert (tmp_path / f"{arch}__{shape}__single.json").exists()


def test_zero1_under_fsdp_is_refused_like_jax(jax_side, tmp_path):
    r = dryrun.run_cell("smollm-360m", "train_4k", "single", out_dir=str(tmp_path),
                        mode="fsdp")
    assert r["status"] == "error"
    want = jax_side["params"]["smollm-360m|single"]["fsdp_zero1"]
    assert want == "DuplicateSpecError"
    assert r["error"].split(":")[0] == want
    assert shd.get_mode() == "tp"                  # the cell restored the mode


def test_init_params_on_meta_draws_nothing(monkeypatch):
    def no_draw(*a, **k):
        raise AssertionError("a weight was drawn")

    monkeypatch.setattr(torch, "randn", no_draw)
    t0 = time.perf_counter()
    model = treg.init_params(treg.get_config("mixtral-8x22b"), device="meta",
                             generator=torch.Generator().manual_seed(0))
    assert time.perf_counter() - t0 < 10.0
    params = list(model.parameters())
    assert all(p.device.type == "meta" for p in params)
    assert sum(p.numel() for p in params) == 140_630_071_296


# ---------------------------------------------------------------------------
# the collective ledger
# ---------------------------------------------------------------------------

def _cpu_mesh(shape, axes):
    devices = np.empty(int(np.prod(shape)), dtype=object)
    devices[:] = [torch.device("cpu")] * devices.size
    return DeviceMesh(devices.reshape(shape), axes)


def test_collective_ledger_counts_a_gather_and_a_psum():
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    t = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    with count_collectives() as stats:
        sh = place(t, mesh, shd.P(None, "model"))           # 4 blocks of (64, 2)
        full = gather(sh, "cpu")                             # an all-gather of 2048 bytes
        one = gather(sh, "cpu", (slice(0, 64), slice(0, 2)))  # inside one block: nothing
        total = psum([t, t, t], "cpu")                       # an all-reduce of 3 parts
    assert torch.equal(full, t) and torch.equal(one, t[:, :2])
    assert torch.equal(total, 3 * t)
    assert stats.count_by_op == {"reduce-scatter": 1, "all-gather": 1, "all-reduce": 1}
    assert stats.bytes_by_op == {"reduce-scatter": 2048 * 3 / 4, "all-gather": 2048 * 3 / 4,
                                 "all-reduce": 2 * 2048 * 2 / 3}
    assert stats.total_bytes == sum(stats.bytes_by_op.values())


def test_collective_ledger_is_inert_when_off(monkeypatch):
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    t = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    with count_collectives() as stats:
        pass

    def recorded(*a):
        raise AssertionError("the ledger recorded a call while it was off")

    # off, a call records and computes nothing for the ledger
    with monkeypatch.context() as m:
        m.setattr(collectives, "_record", recorded)
        sh = place(t, mesh, shd.P("data", "model"))
        off = gather(sh, "cpu")
        assert torch.equal(psum([t, t], "cpu"), 2 * t)
        all_to_all([t, t], ["cpu", "cpu"])
    with count_collectives() as on_stats:
        on = gather(sh, "cpu")
    assert torch.equal(off, on) and torch.equal(off, t)
    assert stats.count_by_op == {} and stats.bytes_by_op == {}
    assert on_stats.count_by_op == {"all-gather": 1}
