"""The port's LM sharding against the JAX package: the logical spec trees of
all ten families, the sharding rules (tp / fsdp / dp on (4, 2), (8, 1) and
(2, 2, 2) meshes, at full width), the collectives, the production mesh, the
int8 error-feedback compressor bit for bit, the sharded MoE (tp and ep)
against ``jax.shard_map``, and the sharded forward, decode and generate
against the unsharded ones.

The JAX side of the compressor and the MoE runs once per module, in a
subprocess with 8 forced host devices, and writes its inputs and results to
an ``.npz`` (``tests/test_torch_grid.py``'s pattern). The port runs in this
process on meshes over ``[cpu] * 8``. The shardings need no devices: JAX's
rules run on ``AbstractMesh``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_lm import CPU
from repro.dist import sharding as jshd
from repro.models import registry as jreg
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import all_to_all, gather, place, psum, region_of
from repro_torch.dist.compression import make_int8_ef_allreduce
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import registry as treg
from repro_torch.models.moe import moe_ffn_local, moe_specs
from repro_torch.models.transformer import _moe_apply
from repro_torch.serve.engine import generate

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = jreg.list_archs()
MESHES = {"4x2": ((4, 2), ("data", "model")), "8x1": ((8, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
MODES = ("tp", "fsdp", "dp")
# the sharded MoE against shard_map: psum and peer copies in another order
MOE_REL = 1e-5
MOE_ARCHS = {"mixtral-8x22b": "tp", "phi3.5-moe-42b-a6.6b": "ep"}
# at this capacity factor the reduced configs drop tokens at 256 tokens, and
# which ones depends on how the tokens split over the data shards
MOE_CF = 1.0


@pytest.fixture(autouse=True)
def tp_mode():
    """Every test starts and ends in the default mode (a process global)."""
    shd.set_mode("tp")
    jshd.set_mode("tp")
    yield
    shd.set_mode("tp")
    jshd.set_mode("tp")


def host_mesh(shape, names) -> DeviceMesh:
    return DeviceMesh(np.array([CPU] * int(np.prod(shape)), dtype=object).reshape(shape),
                      names)


# ---------------------------------------------------------------------------
# specs and sharding rules
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_full(arch: str):
    """(JAX logical specs, parameter shapes) of ``arch`` at full width,
    traced without allocating (the specs are built while tracing)."""
    cfg = jreg.get_config(arch)
    got = {}

    def init():
        params, specs = jreg.init_params(cfg, jax.random.PRNGKey(0))
        got["specs"] = specs
        return params

    shapes = jax.eval_shape(init)
    return got["specs"], shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """``param_specs`` equals the spec tree JAX's ``init_params`` returns,
    reduced and at full width."""
    rcfg = jreg.reduced_config(jreg.get_config(arch))
    assert treg.param_specs(treg.reduced_config(treg.get_config(arch))) == \
        jreg.init_params(rcfg, jax.random.PRNGKey(0))[1]
    assert treg.param_specs(treg.get_config(arch)) == jax_full(arch)[0]


def _specs(tree) -> dict:
    """A NamedSharding tree (either package's) -> path -> spec tuple."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}{k}/")
        else:
            out[path[:-1]] = tuple(t.spec)

    walk(tree, "")
    return out


def _rules(fn_port, fn_jax):
    """Both packages' result, or the fact that both raise."""
    try:
        want = _specs(fn_jax())
    except Exception as e:           # noqa: BLE001 (JAX's error class is private)
        if type(e).__name__ != "DuplicateSpecError":
            raise
        with pytest.raises(ValueError, match="more than one dimension"):
            fn_port()
        return "raises"
    assert _specs(fn_port()) == want
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_jax(arch):
    """``param_shardings`` with and without shapes and ``zero1_shardings``,
    every mode on every mesh, at full width, against JAX's on an
    ``AbstractMesh``."""
    jspecs, shapes = jax_full(arch)
    tspecs = treg.param_specs(treg.get_config(arch))
    zero1 = {}
    for name, (shape, axes) in MESHES.items():
        amesh, tmesh = AbstractMesh(shape, axes), host_mesh(shape, axes)
        for mode in MODES:
            shd.set_mode(mode)
            jshd.set_mode(mode)
            _rules(lambda: shd.param_shardings(tspecs, tmesh),
                   lambda: jshd.param_shardings(jspecs, amesh))
            _rules(lambda: shd.param_shardings(tspecs, tmesh, shapes),
                   lambda: jshd.param_shardings(jspecs, amesh, shapes))
            zero1[name, mode] = _rules(lambda: shd.zero1_shardings(tspecs, shapes, tmesh),
                                       lambda: jshd.zero1_shardings(jspecs, shapes, amesh))
    assert zero1["4x2", "tp"] != "raises" and zero1["4x2", "dp"] != "raises"


def test_smollm_specs_quoted():
    """The two specs the JAX package gives for smollm-360m on (4, 2)."""
    _, shapes = jax_full("smollm-360m")
    specs = treg.param_specs(treg.get_config("smollm-360m"))
    mesh = host_mesh((4, 2), ("data", "model"))
    assert shd.param_shardings(specs, mesh)["embed"]["embedding"].spec == ("model", None)
    z = shd.zero1_shardings(specs, shapes, mesh)
    assert z["blocks"]["attn"]["wq"].spec == (None, "data", "model")
    # under fsdp the batch axes already split ``embed`` and ZeRO-1 would
    # take the 32 layers too: JAX refuses a second use of an axis, as does
    # the port
    shd.set_mode("fsdp")
    with pytest.raises(ValueError, match="more than one dimension"):
        shd.zero1_shardings(specs, shapes, mesh)


def test_specs_without_shapes_raise_where_they_do_not_divide():
    """No hidden fallback: a raw spec that does not divide raises on
    placement; with the shapes, ``_fit_spec`` replicates that dimension."""
    cfg = treg.reduced_config(treg.get_config("smollm-360m"))
    model = treg.init_params(cfg, device=CPU)
    specs = treg.param_specs(cfg)
    mesh = host_mesh((1, 3), ("data", "model"))            # 128 heads over 3
    with pytest.raises(ValueError, match="does not split"):
        shd.place_params(model, shd.param_shardings(specs, mesh), cfg)
    fit = shd.param_shardings(specs, mesh, shd.jax_layout(model, cfg))
    assert fit["blocks"]["attn"]["wq"].spec == (None, None, None)
    shd.place_params(model, fit, cfg)


# ---------------------------------------------------------------------------
# collectives and meshes
# ---------------------------------------------------------------------------

def test_place_and_gather_round_trip():
    mesh = host_mesh((2, 2, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    sh = place(t, mesh, (("pod", "data"), "model", None))
    assert len(sh.shards) == 8 and all(s.shape == (2, 3, 4) for s in sh.shards.values())
    assert sh.region((1, 0, 1)) == (slice(4, 6), slice(3, 6), slice(0, 4))
    assert torch.equal(gather(sh, CPU), t)
    # a region across blocks, and one inside a block (a view of the shard)
    r = (slice(1, 7), slice(2, 5), slice(1, 3))
    assert torch.equal(gather(sh, CPU, r), t[r])
    inner = gather(sh, CPU, (slice(4, 6), slice(3, 6), slice(0, 4)))
    assert inner._base is not None
    # a stacked leaf's layer lives only on the data rows that hold its block
    layers = place(t[5], mesh, ("data", None, "model"), layer=(5, 8))
    assert sorted(layers.shards) == [(0, 1, 0), (0, 1, 1), (1, 1, 0), (1, 1, 1)]
    assert torch.equal(gather(layers, CPU), t[5])
    with pytest.raises(ValueError, match="does not split"):
        place(t, mesh, (None, None, ("pod", "data", "model")))
    with pytest.raises(ValueError):
        place(t[:, :5], mesh, (None, "model"))


def test_psum_and_all_to_all():
    parts = [torch.full((4, 3), float(i)) for i in range(4)]
    assert torch.equal(psum(parts, CPU), torch.full((4, 3), 6.0))
    # the tiled block transpose: rank m receives block m of every rank
    src = [torch.arange(8).reshape(4, 2) + 100 * r for r in range(4)]
    got = all_to_all(src, [CPU] * 4)
    for m in range(4):
        assert torch.equal(got[m], torch.cat([src[r][m:m + 1] for r in range(4)]))


def test_make_production_mesh():
    mesh = make_production_mesh(devices=[CPU] * 256)
    assert mesh.shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert shd.batch_axes(multi) == ("pod", "data")
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=[CPU] * 8)
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, devices=[CPU] * 256)


def test_production_mesh_needs_a_card_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()


# ---------------------------------------------------------------------------
# the JAX side: the compressor and the MoE on 8 forced host devices
# ---------------------------------------------------------------------------

_ORACLE = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.dist.compression import make_int8_ef_allreduce
    from repro.dist.sharding import spec_of
    from repro.models import moe, registry

    out = {}
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": (rng.normal(size=(7,)) * 1e-3).astype(np.float32),
         "z": np.zeros((5,), np.float32)}
    for k, v in g.items():
        out["g/" + k] = v
    for axes, shape in ((("data",), (8,)), (("data",), (4, 2)), (("pod", "data"), (2, 2, 2))):
        names = axes + ("model",) if len(shape) > len(axes) else axes
        mesh = jax.make_mesh(shape, names)
        init, compress = make_int8_ef_allreduce(mesh, axes)
        tag = "x".join(map(str, shape))
        ef = init(g)
        for step in range(8):
            g_hat, ef = compress(g, ef)
            for k in g:
                out[f"{tag}/{step}/g/{k}"] = np.asarray(g_hat[k])
                out[f"{tag}/{step}/ef/{k}"] = np.asarray(ef[k])

    mesh = jax.make_mesh((2, 4), ("data", "model"))
    for arch in ("mixtral-8x22b", "phi3.5-moe-42b-a6.6b"):
        cfg = dataclasses.replace(registry.reduced_config(registry.get_config(arch)),
                                  capacity_factor=1.0)
        p, s = moe.init_moe(cfg, jax.random.PRNGKey(3), jnp.float32)
        x = jax.random.normal(jax.random.PRNGKey(4), (256, cfg.d_model), jnp.float32)
        pspecs = jax.tree.map(lambda a: spec_of(a, mesh), s,
                              is_leaf=lambda v: isinstance(v, tuple))
        for xs, n in ((P("data", None), 256), (P(None, None), 7)):
            fn = jax.shard_map(
                lambda p_, x_: moe.moe_ffn_local(p_, cfg, x_, model_axis="model"),
                mesh=mesh, in_specs=(pspecs, xs), out_specs=xs, check_vma=False)
            out[f"{arch}/y{n}"] = np.asarray(fn(p, x[:n]))
        for k, v in p.items():
            out[f"{arch}/p/{k}"] = np.asarray(v)
        out[f"{arch}/x"] = np.asarray(x)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "oracle.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _ORACLE, path], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return dict(np.load(path))


@pytest.mark.parametrize("tag,axes,names", [
    ("8", ("data",), ("data",)),
    ("4x2", ("data",), ("data", "model")),
    ("2x2x2", ("pod", "data"), ("pod", "data", "model"))])
def test_compress_matches_jax_bit_for_bit(oracle, tag, axes, names):
    """``compress`` on replicated gradients equals JAX's bit for bit, every
    one of eight steps (the error feedback carried), over one axis or two."""
    shape = tuple(int(n) for n in tag.split("x"))
    init, compress = make_int8_ef_allreduce(host_mesh(shape, names), axes)
    g = {k: torch.from_numpy(oracle["g/" + k]) for k in ("w", "b", "z")}
    ef = init(g)
    for step in range(8):
        g_hat, ef = compress(g, ef)
        for k in g:
            assert np.array_equal(g_hat[k].numpy(), oracle[f"{tag}/{step}/g/{k}"]), (step, k)
            assert np.array_equal(ef[k].numpy(), oracle[f"{tag}/{step}/ef/{k}"]), (step, k)


def test_compress_is_unbiased_over_steps():
    """``tests/test_compression.py`` restated: single-step relative error
    below 2e-2, and the 8-step error-fed sum within 2e-2 of 8 g."""
    init, compress = make_int8_ef_allreduce(host_mesh((8,), ("data",)), ("data",))
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    g1, _ = compress(g_true, init(g_true))
    rel = float((g1["w"] - g_true["w"]).abs().max() / g_true["w"].abs().max())
    assert rel < 2e-2, rel
    total = torch.zeros_like(g_true["w"])
    ef = init(g_true)
    for _ in range(8):
        g_hat, ef = compress(g_true, ef)
        total = total + g_hat["w"]
    drift = float((total - 8 * g_true["w"]).abs().max() / g_true["w"].abs().max())
    assert drift < 2e-2, drift


def _placed_moe(oracle, arch, mesh):
    cfg = dataclasses.replace(treg.reduced_config(treg.get_config(arch)),
                              capacity_factor=MOE_CF)
    leaves = {k: place(torch.from_numpy(oracle[f"{arch}/p/{k}"]), mesh, shd.spec_of(s, mesh))
              for k, s in moe_specs(cfg).items()}
    return cfg, shd.ShardedModel(mesh, leaves)


@pytest.mark.parametrize("arch", sorted(MOE_ARCHS))
def test_sharded_moe_matches_shard_map(oracle, arch):
    """The tp psum (mixtral) and the ep all_to_alls (phi3.5-moe) on a (2, 4)
    mesh against ``jax.shard_map`` of JAX's ``moe_ffn_local``: 256 tokens in
    two data shards, each dispatched on its own, at a capacity factor where
    the drops make the result differ from one dispatch over all 256; and 7
    tokens, which do not split over the data axis and are
    replicated."""
    mesh = host_mesh((2, 4), ("data", "model"))
    cfg, placed = _placed_moe(oracle, arch, mesh)
    assert cfg.moe_sharding == MOE_ARCHS[arch]
    x = torch.from_numpy(oracle[f"{arch}/x"])
    for n in (256, 7):
        want = oracle[f"{arch}/y{n}"]
        got = _moe_apply(placed.view(CPU, None), cfg, x[None, :n], mesh)[0].numpy()
        err = float(np.abs(got - want).max()) / float(np.abs(want).max())
        assert err < MOE_REL, (n, err)
    # the unsharded dispatch over all 256 tokens drops others
    whole = moe_ffn_local(placed.view(CPU, None), cfg, x).numpy()
    assert float(np.abs(whole - oracle[f"{arch}/y256"]).max()) > 1e-2 * float(
        np.abs(whole).max())


def test_moe_model_axis_ranks_hold_their_shards(oracle):
    """``moe_ffn_local(model_axis=)`` reads each model rank's own block:
    the ep experts and the tp f-slices of ``spec_of(moe_specs)``."""
    mesh = host_mesh((2, 4), ("data", "model"))
    for arch, mode in MOE_ARCHS.items():
        cfg, placed = _placed_moe(oracle, arch, mesh)
        leaf = placed.leaves["w_gate"]
        r = region_of(mesh, shd.spec_of(moe_specs(cfg)["w_gate"], mesh), leaf.shape, (1, 2))
        axis = 0 if mode == "ep" else 2
        assert r[axis] == slice(2 * leaf.shape[axis] // 4, 3 * leaf.shape[axis] // 4)


# ---------------------------------------------------------------------------
# the sharded forward, prefill, decode and generate
# ---------------------------------------------------------------------------

def _placed(arch, mesh, **over):
    cfg = dataclasses.replace(treg.reduced_config(treg.get_config(arch)), **over)
    model = treg.init_params(cfg, generator=torch.Generator().manual_seed(0), device=CPU)
    specs = treg.param_specs(cfg)
    placed = shd.place_params(model, shd.param_shardings(specs, mesh, shd.jax_layout(model, cfg)),
                              cfg)
    return cfg, model, placed


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen1.5-32b", "phi3.5-moe-42b-a6.6b",
                                  "rwkv6-3b", "zamba2-2.7b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_sharded_forward_matches_unsharded(arch, mode):
    """``registry.forward(mesh=)`` on a (4, 2) mesh equals the one-device
    forward (the MoE at a capacity that drops nothing: its drops depend on
    the data shards)."""
    shd.set_mode(mode)
    mesh = host_mesh((4, 2), ("data", "model"))
    over = {"capacity_factor": 8.0} if arch.startswith("phi3.5") else {}
    cfg, model, placed = _placed(arch, mesh, **over)
    r = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (4, 64)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(r.normal(size=(4, 64, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["img"] = torch.from_numpy(
            r.normal(size=(4, cfg.n_patches, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        want = treg.forward(model, cfg, batch)
        got = treg.forward(placed, cfg, batch, mesh=mesh)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b", "rwkv6-3b", "whisper-base"])
def test_sharded_decode_matches_unsharded(arch):
    """Prefill with caches and three decode steps over the mesh, the cache
    rows of each data rank written in place, equal the one-device ones;
    a batch of 3 rows does not split over 4 data ranks and runs whole."""
    mesh = host_mesh((4, 2), ("data", "model"))
    over = {"capacity_factor": 8.0} if arch == "mixtral-8x22b" else {}
    cfg, model, placed = _placed(arch, mesh, **over)
    r = np.random.default_rng(2)
    for b in (4, 3):
        toks = torch.from_numpy(r.integers(0, cfg.vocab, (b, 8)))
        if cfg.family == "encdec":
            from repro_torch.models import encdec
            frames = torch.from_numpy(r.normal(size=(b, 16, cfg.d_model)).astype(np.float32))
            caches = [treg.init_caches(cfg, b, 16, device=CPU) for _ in range(2)]
            with torch.no_grad():
                for c in caches:
                    c["cross"] = encdec.precompute_cross_kv(
                        model, cfg, encdec.encode(model, cfg, frames))
                    c["enc_len"] = 16
        else:
            from repro_torch.models.transformer import forward_with_caches
            want_l, c0 = forward_with_caches(model, cfg, toks, 16)
            got_l, c1 = forward_with_caches(placed, cfg, toks, 16, mesh=mesh)
            torch.testing.assert_close(got_l, want_l, rtol=1e-5, atol=1e-5)
            caches = [c0, c1]
        tok = toks[:, -1:]
        for _ in range(3):
            want, caches[0] = treg.decode_step(model, cfg, {"tokens": tok}, caches[0])
            got, caches[1] = treg.decode_step(placed, cfg, {"tokens": tok}, caches[1],
                                              mesh=mesh)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            assert caches[0]["len"] == caches[1]["len"]
            tok = torch.argmax(want[:, -1], dim=-1)[:, None]


def test_sharded_generate_matches_unsharded():
    mesh = host_mesh((4, 2), ("data", "model"))
    cfg, model, placed = _placed("smollm-360m", mesh)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, 16))
    want = generate(model, cfg, toks, max_new=6, device="cpu")
    assert np.array_equal(generate(placed, cfg, toks, max_new=6, device="cpu", mesh=mesh), want)


def test_mesh_needs_placed_parameters():
    mesh = host_mesh((4, 2), ("data", "model"))
    cfg, model, placed = _placed("smollm-360m", mesh)
    toks = torch.zeros((4, 8), dtype=torch.long)
    with pytest.raises(TypeError, match="placed"):
        treg.forward(model, cfg, {"tokens": toks}, mesh=mesh)
    with pytest.raises(ValueError, match="mesh="):
        treg.forward(placed, cfg, {"tokens": toks})
