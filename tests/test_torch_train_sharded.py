"""The port's sharded train step against the single-device steps, the port's
and the JAX package's (the JAX package's own sharded step fails on its
vocab-sharded embedding gather, ``tests/test_distributed.py``).

On (4, 2) and (2, 2, 2) meshes over ``[cpu] * 8``, in tp, fsdp and dp, at
accum 1 and 2 and with the int8 error-feedback compressor: the loss, the
grad norm, the ZeRO-1 moments and the parameters after a step, by
``tests/_torch_train.py``'s rules, and where each moment shard lies. Also:
a ZeRO-1 split of the stacked ``layers`` axis, the MoE, ``launch.train
--mesh local`` against ``--mesh none``, and sharded checkpoints against
unsharded ones, both ways.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from _torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,  # noqa: F401 (one_thread)
                          assert_leaves_close, assert_params_close, assert_state_matches,
                          jax_step, labelled, one_thread, private_pair, resolved_v, to_jax,
                          to_torch)
from repro.train import optimizer as jopt
from repro.train import trainer as jtr
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.convert import lm_params_from_jax
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import gather, region_of
from repro_torch.dist.compression import make_int8_ef_allreduce
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.models import registry as treg
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.trainer import build_train_step, loss_fn

CPU = torch.device("cpu")
LR = 1e-3
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
B, S = 8, 32


@pytest.fixture(autouse=True)
def tp_mode():
    shd.set_mode("tp")
    yield
    shd.set_mode("tp")


def host_mesh(name) -> DeviceMesh:
    shape, axes = MESHES[name]
    return DeviceMesh(np.array([CPU] * 8, dtype=object).reshape(shape), axes)


def _setup(arch, mesh, mode, **over):
    """The pair of ``private_pair``, the port's weights placed on ``mesh``
    under ``mode``, and ZeRO-1 moments (under fsdp, where JAX refuses the
    ZeRO-1 specs, moments placed like the parameters)."""
    jcfg, jparams, tcfg, model = private_pair(arch, **over)
    shd.set_mode(mode)
    specs = treg.param_specs(tcfg)
    shapes = shd.jax_layout(model, tcfg)
    placed = shd.place_params(model, shd.param_shardings(specs, mesh, shapes), tcfg)
    zero1 = None if mode == "fsdp" else shd.zero1_shardings(specs, shapes, mesh)
    opt = init_opt_state(placed, zero1, cfg=tcfg)
    return jcfg, jparams, tcfg, model, placed, opt, zero1


def _gathered(model, placed, opt):
    """The sharded state whole on the host: a module and an AdamW state."""
    full = copy.deepcopy(model)
    full.load_state_dict(placed.full())
    return full, {"m": {n: gather(t, CPU) for n, t in opt["m"].items()},
                  "v": {n: gather(t, CPU) for n, t in opt["v"].items()},
                  "step": opt["step"]}


def _assert_zero1_placement(placed, opt, zero1, cfg):
    """Every moment shard sits at the mesh positions its ZeRO-1 spec names
    (a stacked leaf's layer only where the spec's layer block holds it),
    holds that block, and lies on that position's device."""
    mesh = placed.mesh
    names = list(placed.leaves)
    for name, (sharding, layer) in shd.per_leaf(zero1, names, cfg).items():
        full_shape = placed.leaves[name].shape
        shape = full_shape if layer is None else (layer[1],) + full_shape
        for part in ("m", "v"):
            sh = opt[part][name]
            for pos in np.ndindex(*mesh.devices.shape):
                r = region_of(mesh, sharding.spec, shape, pos)
                if layer is not None:
                    if not r[0].start <= layer[0] < r[0].stop:
                        assert pos not in sh.shards, (name, pos)
                        continue
                    r = r[1:]
                t = sh.shards[pos]
                assert tuple(t.shape) == tuple(s.stop - s.start for s in r), (name, pos)
                assert t.device == mesh.devices[pos] and t.dtype == torch.float32


def _one_device(model, tcfg, batch, accum):
    ref = copy.deepcopy(model)
    opt = init_opt_state(ref)
    ref, opt, met = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=0),
                                     accum=accum)(ref, opt, batch)
    return ref, opt, met


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mode", ["tp", "fsdp", "dp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_step_matches_single_device(mesh_name, mode, accum):
    """Loss (rtol 1e-5), grad norm, moments and parameters of one step
    against the port's and JAX's single-device steps; the moments where
    ZeRO-1 puts them."""
    arch = "smollm-360m"
    mesh = host_mesh(mesh_name)
    jcfg, jparams, tcfg, model, placed, opt, zero1 = _setup(arch, mesh, mode)
    batch = labelled(jcfg, b=B, s=S)
    step = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=0), mesh=mesh, accum=accum,
                            moment_specs=None if zero1 is None else shd.specs_of(zero1))
    _, opt, met = step(placed, opt, to_torch(batch))
    ref, ropt, rmet = _one_device(model, tcfg, to_torch(batch), accum)
    jp, jo, jm = jax_step(arch, accum)(jparams, jopt.init_opt_state(jparams), to_jax(batch))
    for key in ("loss", "grad_norm", "lr"):
        for want in (float(rmet[key]), float(jm[key])):
            np.testing.assert_allclose(float(met[key]), want, rtol=LOSS_RTOL, err_msg=key)
    full, fopt = _gathered(model, placed, opt)
    assert_state_matches(arch, tcfg, full, fopt, jp, jo, LR, 1)
    assert_leaves_close(fopt["m"], ropt["m"], GRAD_ATOL, GRAD_RTOL, "m vs port")
    assert_leaves_close(fopt["v"], ropt["v"], 2 * GRAD_ATOL, 2 * GRAD_RTOL, "v vs port")
    assert_params_close(dict(full.named_parameters()), dict(ref.named_parameters()),
                        resolved_v(ropt["v"]), LR)
    if zero1 is not None:
        _assert_zero1_placement(placed, opt, zero1, tcfg)
    else:                            # fsdp: each moment shard beside its parameter's
        for name, sh in placed.leaves.items():
            assert {p: t.shape for p, t in opt["m"][name].shards.items()} == \
                {p: t.shape for p, t in sh.shards.items()}


@pytest.mark.parametrize("mode", ["tp", "fsdp", "dp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_step_with_compressor(mesh_name, mode):
    """The compressor hook runs between the reduced gradients and the
    update, as in JAX: the gradients it receives match the single-device
    gradients (the port's and JAX's), the loss matches, and the update is a
    one-device ``adamw_update`` of exactly the gradients it returned, bit
    for bit (a quantized gradient is a step function of its input, so the
    two paths' float32 rounding may land one int8 step apart)."""
    arch = "smollm-360m"
    mesh = host_mesh(mesh_name)
    jcfg, jparams, tcfg, model, placed, opt, zero1 = _setup(arch, mesh, mode)
    init, compress = make_int8_ef_allreduce(mesh, shd.batch_axes(mesh))
    opt["ef"] = init({n: torch.zeros(sh.shape) for n, sh in placed.leaves.items()})
    seen = {}

    def hook(grads, state):
        seen["in"] = {k: v.clone() for k, v in grads.items()}
        seen["out"], state["ef"] = compress(grads, state["ef"])
        return seen["out"], state

    batch = labelled(jcfg, b=B, s=S)
    step = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=0), mesh=mesh,
                            moment_specs=None if zero1 is None else shd.specs_of(zero1),
                            compressor=hook)
    _, opt, met = step(placed, opt, to_torch(batch))

    ref = copy.deepcopy(model).requires_grad_(True)
    loss = loss_fn(ref, tcfg, to_torch(batch))
    loss.backward()
    grads = {n: p.grad for n, p in ref.named_parameters()}
    np.testing.assert_allclose(float(met["loss"]), float(loss.detach()), rtol=LOSS_RTOL)
    assert_leaves_close(seen["in"], grads, GRAD_ATOL, GRAD_RTOL, "grad vs port")
    jgrads = jax.grad(jtr.loss_fn)(jparams, jcfg, to_jax(batch))
    assert_leaves_close(seen["in"], lm_params_from_jax(jgrads, tcfg), GRAD_ATOL, GRAD_RTOL,
                        "grad vs JAX")
    ref = copy.deepcopy(model)
    ropt = init_opt_state(ref)
    _, ropt, rmet = adamw_update(AdamWConfig(lr=LR, warmup_steps=0), ref, seen["out"], ropt)
    assert float(rmet["grad_norm"]) == float(met["grad_norm"])
    full, fopt = _gathered(model, placed, opt)
    for name, p in ref.named_parameters():
        assert torch.equal(full.state_dict()[name], p.detach()), name
        assert torch.equal(fopt["m"][name], ropt["m"][name]), name
        assert torch.equal(fopt["v"][name], ropt["v"][name]), name


@pytest.mark.parametrize("arch,over", [
    ("qwen1.5-32b", {}),                             # bq/bk/bv: ZeRO-1 splits the layers
    ("mixtral-8x22b", {"capacity_factor": 8.0}),     # the tp MoE, dropping nothing
    ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 8.0})])
def test_sharded_step_other_families(arch, over):
    """The step of a family whose stacked biases ZeRO-1 splits over the
    layers axis, and of both MoE collectives, against both single-device
    steps on (4, 2) in tp."""
    mesh = host_mesh("4x2")
    jcfg, jparams, tcfg, model, placed, opt, zero1 = _setup(arch, mesh, "tp", **over)
    if arch == "qwen1.5-32b":
        bq = shd.jax_leaf(zero1, "blocks.1.attn.bq")[0]
        assert bq.spec == ("data", "model")
    batch = labelled(jcfg, b=B, s=S)
    step = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=0), mesh=mesh,
                            moment_specs=shd.specs_of(zero1))
    _, opt, met = step(placed, opt, to_torch(batch))
    ref, ropt, rmet = _one_device(model, tcfg, to_torch(batch), 1)
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]), rtol=LOSS_RTOL)
    full, fopt = _gathered(model, placed, opt)
    assert_leaves_close(fopt["m"], ropt["m"], GRAD_ATOL, GRAD_RTOL, "m vs port")
    assert_params_close(dict(full.named_parameters()), dict(ref.named_parameters()),
                        resolved_v(ropt["v"]), LR)
    _assert_zero1_placement(placed, opt, zero1, tcfg)
    if not over:                                     # the JAX step has its own drops
        jp, jo, jm = jax_step(arch)(jparams, jopt.init_opt_state(jparams), to_jax(batch))
        np.testing.assert_allclose(float(met["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        assert_state_matches(arch, tcfg, full, fopt, jp, jo, LR, 1)


def test_block_remat_gathers_again_in_the_backward(monkeypatch):
    """Under ``remat="block"`` a block's leaves are gathered inside the
    recomputed region: each block leaf is gathered once more a rank (in
    the backward pass), so no gathered copy outlives its block; the step
    is the same."""
    mesh = host_mesh("4x2")
    real, counts, losses = shd.gather, {}, {}
    for remat in ("none", "block"):
        counts[remat] = 0

        def counting(*args, remat=remat, **kw):
            counts[remat] += 1
            return real(*args, **kw)

        monkeypatch.setattr(shd, "gather", counting)
        jcfg, _, tcfg, _, placed, opt, zero1 = _setup("smollm-360m", mesh, "tp", remat=remat)
        step = build_train_step(tcfg, AdamWConfig(lr=LR), mesh=mesh,
                                moment_specs=shd.specs_of(zero1))
        _, _, met = step(placed, opt, to_torch(labelled(jcfg, b=B, s=S)))
        losses[remat] = float(met["loss"])
    per_block = len([n for n in placed.leaves if n.startswith("blocks.0.")])
    assert counts["block"] - counts["none"] == per_block * tcfg.n_layers * shd.n_data_ranks(mesh)
    assert losses["block"] == losses["none"]


def test_sharded_step_refuses_what_does_not_split():
    mesh = host_mesh("4x2")
    jcfg, _, tcfg, model, placed, opt, zero1 = _setup("smollm-360m", mesh, "tp")
    step = build_train_step(tcfg, AdamWConfig(lr=LR), mesh=mesh)
    with pytest.raises(ValueError, match="does not split"):
        step(placed, opt, to_torch(labelled(jcfg, b=6, s=S)))
    with pytest.raises(ValueError, match="moment_specs"):
        build_train_step(tcfg, AdamWConfig(), moment_specs=shd.specs_of(zero1))
    wrong = build_train_step(tcfg, AdamWConfig(lr=LR), mesh=mesh,
                             moment_specs=shd._map(lambda s, z: shd.P(*[None] * len(s)),
                                                   treg.param_specs(tcfg), zero1))
    with pytest.raises(ValueError, match="moment_specs say"):
        wrong(placed, opt, to_torch(labelled(jcfg, b=B, s=S)))


# ---------------------------------------------------------------------------
# checkpoints and launch.train
# ---------------------------------------------------------------------------

def _state_equal(a_model, a_opt, b_model, b_opt):
    assert all(torch.equal(a_model[n], b_model[n]) for n in a_model)
    for part in ("m", "v"):
        assert all(torch.equal(a_opt[part][n], b_opt[part][n]) for n in a_opt[part])
    assert int(a_opt["step"]) == int(b_opt["step"])


def test_sharded_checkpoint_restores_both_ways(tmp_path):
    """A sharded state saved and restored into an unsharded model is the
    same bit for bit, and an unsharded one restored into a sharded state
    lands in every shard."""
    mesh = host_mesh("4x2")
    jcfg, _, tcfg, model, placed, opt, _ = _setup("qwen1.5-32b", mesh, "tp")
    step = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=0), mesh=mesh)
    _, opt, _ = step(placed, opt, to_torch(labelled(jcfg, b=B, s=S)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_train_state(1, placed, opt, tcfg)
    back = treg.init_params(tcfg, generator=torch.Generator().manual_seed(1), device=CPU)
    bopt = init_opt_state(back)
    assert mgr.restore_train_state(1, back, bopt, tcfg) == 1
    full, fopt = _gathered(model, placed, opt)
    _state_equal(full.state_dict(), fopt, back.state_dict(), bopt)

    # the other way: train the unsharded model on, save, restore into the mesh
    back, bopt, _ = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=0))(
        back, bopt, to_torch(labelled(jcfg, b=B, s=S, seed=1)))
    mgr.save_train_state(2, back, bopt, tcfg)
    _, _, _, _, placed2, opt2, _ = _setup("qwen1.5-32b", mesh, "tp")
    assert mgr.restore_train_state(2, placed2, opt2, tcfg) == 2
    full2, fopt2 = _gathered(model, placed2, opt2)
    _state_equal(back.state_dict(), bopt, full2.state_dict(), fopt2)
    for name, sh in placed2.leaves.items():
        for pos, t in sh.shards.items():
            assert torch.equal(t, back.state_dict()[name][sh.region(pos)])


_TRAIN = ["--device", "cpu", "--reduce", "--steps", "4", "--batch", "4", "--seq", "32",
          "--ckpt-every", "2", "--accum", "2"]


def test_launch_train_mesh_local_equals_none(tmp_path):
    """``--mesh local`` on the host is a (1, 1) mesh: placed weights, ZeRO-1
    moments, the batch placed over ``data``; its run equals ``--mesh none``
    bit for bit, and it resumes from its own checkpoint."""
    m0, o0, h0 = launch_train.main(_TRAIN + ["--ckpt-dir", str(tmp_path / "none")])
    m1, o1, h1 = launch_train.main(_TRAIN + ["--ckpt-dir", str(tmp_path / "local"),
                                             "--mesh", "local"])
    assert isinstance(m1, shd.ShardedModel) and m1.mesh.shape == {"data": 1, "model": 1}
    # the clock may add straggler steps to either history: the log_every
    # steps are in both, and every step both logged has the same loss
    l0, l1 = dict(h[:2] for h in h0), dict(h[:2] for h in h1)
    both = l0.keys() & l1.keys()
    assert {0} <= both and {s: l0[s] for s in both} == {s: l1[s] for s in both}
    _state_equal({n: p.detach() for n, p in m0.named_parameters()}, o0, m1.full(),
                 {"m": {n: gather(t, CPU) for n, t in o1["m"].items()},
                  "v": {n: gather(t, CPU) for n, t in o1["v"].items()}, "step": o1["step"]})
    m2, o2, _ = launch_train.main(_TRAIN[:4] + ["6"] + _TRAIN[5:] + [
        "--ckpt-dir", str(tmp_path / "local"), "--mesh", "local"])
    assert int(o2["step"]) == 6


@pytest.mark.parametrize("mesh,need", [("single", 256), ("multi", 512)])
def test_launch_train_production_mesh_needs_its_devices(tmp_path, mesh, need):
    with pytest.raises(ValueError, match=f"needs {need} devices"):
        launch_train.main(_TRAIN + ["--ckpt-dir", str(tmp_path), "--mesh", mesh])
