"""Checkpoints shared with the JAX package: a file either package writes,
the other restores and trains on as if it had written it; bfloat16 leaves
come back bit for bit; the port's file for a state has the JAX file's
manifest, dtypes and leaf bytes; the port restores in place."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (assert_state_matches, jax_step, labelled,  # noqa: F401
                          one_thread, private_pair, resolved, to_jax, to_torch)
from repro.ckpt.manager import CheckpointManager as JaxCheckpointManager
from repro.models import registry as jreg
from repro.train import optimizer as jopt
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.models import registry
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import build_train_step

# the learning rate warms up over the first steps: a first step at the full
# rate moves each weight by ~lr x sign(g), and the elements whose gradients
# differ in sign at float32 rounding would part the two runs' later steps
# (tests/test_torch_train_parity.py's five-step test)
ARCH, LR, WARMUP = "smollm-360m", 1e-3, 5


def _jax_trained(steps: int):
    """(JAX cfg, port cfg, a port module of the same architecture, JAX params
    and AdamW state after ``steps`` steps)."""
    jcfg, jparams, tcfg, model = private_pair(ARCH)
    jo = jopt.init_opt_state(jparams)
    for i in range(steps):
        jparams, jo, _ = jax_step(ARCH, warmup=WARMUP)(jparams, jo, to_jax(labelled(jcfg, seed=i)))
    return jcfg, tcfg, model, jparams, jo


def _continue(jcfg, tcfg, model, opt, jparams, jo, first: int, steps: int = 2):
    step = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=WARMUP))
    masks, lr_sum = None, 0.0
    for i in range(first, first + steps):
        batch = labelled(jcfg, seed=i)
        jparams, jo, jm = jax_step(ARCH, warmup=WARMUP)(jparams, jo, to_jax(batch))
        model, opt, _ = step(model, opt, to_torch(batch))
        masks, lr_sum = resolved(jo, tcfg, masks), lr_sum + float(jm["lr"])
    assert_state_matches(ARCH, tcfg, model, opt, jparams, jo, lr_sum, first + steps, masks)


def _assert_restored_exactly(tcfg, model, opt, jparams, jo):
    want_p = lm_params_from_jax(jparams, tcfg)
    want_o = opt_state_from_jax(jo, tcfg)
    for name, p in model.state_dict().items():
        assert torch.equal(p, want_p[name]), name
    for part in ("m", "v"):
        for name, t in opt[part].items():
            assert torch.equal(t, want_o[part][name]), (part, name)
    assert int(opt["step"]) == int(want_o["step"])


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """JAX writes (params, opt_state) after 2 steps; the port restores it
    into a model of other weights, in place, exactly, and its next 2 steps
    follow JAX's."""
    jcfg, tcfg, model, jparams, jo = _jax_trained(2)
    JaxCheckpointManager(str(tmp_path)).save(2, (jparams, jo))
    model.load_state_dict(registry.init_params(tcfg, device="cpu").state_dict())
    opt = init_opt_state(model)
    ptrs = [p.data_ptr() for p in model.parameters()] + [t.data_ptr() for t in opt["m"].values()]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_train_state(mgr.latest_step(), model, opt, tcfg) == 2
    assert ptrs == [p.data_ptr() for p in model.parameters()] + \
        [t.data_ptr() for t in opt["m"].values()]
    _assert_restored_exactly(tcfg, model, opt, jparams, jo)
    _continue(jcfg, tcfg, model, opt, jparams, jo, first=2)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    """The port writes its state after 2 steps (from JAX's weights); JAX's
    own CheckpointManager restores it, and JAX's next 2 steps follow the
    port's."""
    jcfg, jparams0, tcfg, model = private_pair(ARCH)
    step = build_train_step(tcfg, AdamWConfig(lr=LR, warmup_steps=WARMUP))
    opt = init_opt_state(model)
    for i in range(2):
        model, opt, _ = step(model, opt, to_torch(labelled(jcfg, seed=i)))
    CheckpointManager(str(tmp_path)).save_train_state(2, model, opt, tcfg)
    like = (jparams0, jopt.init_opt_state(jparams0))
    (jparams, jo), stored = JaxCheckpointManager(str(tmp_path)).restore(2, like)
    assert stored == 2
    jparams, jo = jax.tree.map(jnp.asarray, (jparams, jo))
    _assert_restored_exactly(tcfg, model, opt, jparams, jo)
    _continue(jcfg, tcfg, model, opt, jparams, jo, first=2)


def _bf16_state():
    cfg = dataclasses.replace(jreg.reduced_config(jreg.get_config(ARCH)),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams, _ = jreg.init_params(cfg, jax.random.PRNGKey(1))
    jo = {"m": jax.tree.map(lambda p: p.astype(jnp.float32) * 0.25, jparams),
          "v": jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)), jparams),
          "step": jnp.asarray(5, jnp.int32)}
    tcfg = dataclasses.replace(registry.reduced_config(registry.get_config(ARCH)),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    return tcfg, jparams, jo


def test_bfloat16_checkpoint_round_trips_between_the_packages(tmp_path):
    """The port restores JAX's bfloat16 file bit for bit (its leaves are
    2-byte void bits), and its own file for the same state has JAX's
    manifest, dtypes and leaf bytes."""
    tcfg, jparams, jo = _bf16_state()
    JaxCheckpointManager(str(tmp_path / "jax")).save(5, (jparams, jo))
    model = registry.init_params(tcfg, device="cpu")
    opt = init_opt_state(model)
    CheckpointManager(str(tmp_path / "jax")).restore_train_state(5, model, opt, tcfg)
    assert model.embed.embedding.dtype == torch.bfloat16
    _assert_restored_exactly(tcfg, model, opt, jparams, jo)

    CheckpointManager(str(tmp_path / "port")).save_train_state(5, model, opt, tcfg)
    with np.load(tmp_path / "jax" / "ckpt_00000005.npz") as jz, \
            np.load(tmp_path / "port" / "ckpt_00000005.npz") as tz:
        assert str(jz["__manifest__"]) == str(tz["__manifest__"])
        assert sorted(jz.files) == sorted(tz.files)
        kinds = set()
        for key in jz.files:
            assert jz[key].dtype == tz[key].dtype, key
            assert jz[key].shape == tz[key].shape, key
            assert jz[key].tobytes() == tz[key].tobytes(), key
            kinds.add(jz[key].dtype.str)
    assert {"|V2", "<f4", "<i4"} <= kinds       # bf16 params, f32 moments, the step


def test_restore_refuses_another_structure_or_dtype(tmp_path):
    tcfg, jparams, jo = _bf16_state()
    JaxCheckpointManager(str(tmp_path)).save(5, (jparams, jo))
    mgr = CheckpointManager(str(tmp_path))
    f32 = registry.init_params(dataclasses.replace(tcfg, param_dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore_train_state(5, f32, init_opt_state(f32), tcfg)
    deeper = dataclasses.replace(tcfg, n_layers=tcfg.n_layers + 1)
    model = registry.init_params(deeper, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore_train_state(5, model, init_opt_state(model), deeper)
    with pytest.raises(AssertionError, match="structure"):
        mgr.restore(5, {"params": jparams})
