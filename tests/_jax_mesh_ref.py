"""The reference on four host devices, for ``tests/test_torch_distributed.py``.

Run as a script in its own process (the test process already holds a
one-device JAX):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_jax_mesh_ref.py inputs.pkl outputs.pkl

``inputs.pkl`` holds the port's params and batches as numpy; the outputs
are, per case, what the reference computes on meshes over those devices:
device slices of every param leaf, ``psum_compressed`` under
``shard_map``, the compressed data-parallel step, and ``jit_train_step``
beside the unsharded jitted step.  The meshes use Auto axes: under this
jax, ``jax.make_mesh`` gives Explicit axes, on which the reference's
``constrain`` raises.
"""
from __future__ import annotations

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.optim import OptConfig, adamw_init, compression
from repro.train import TrainState, jit_train_step, make_compressed_dp_train_step
from repro.train import make_train_step, sharding
from repro.utils import act_sharding


def mesh(shape: tuple, axes: tuple):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), axes,
                             axis_types=(AxisType.Auto,) * len(axes))


def params_from(cfg, leaves: dict):
    """The reference's param tree with the port's leaves."""
    tree = jzoo.init_params(cfg, jax.random.PRNGKey(0))

    def put(path, leaf):
        key = "/".join(str(k.key) for k in path)
        assert leaves[key].shape == leaf.shape, key
        return jnp.asarray(leaves[key])

    return jax.tree_util.tree_map_with_path(put, tree)


def flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def placements(params, fsdp: bool) -> dict:
    """Per leaf, each device's slice as (start, stop) per dimension, in the
    mesh's row-major device order (rank order of a DeviceMesh)."""
    m = mesh((2, 2), ("data", "model"))
    specs = sharding.param_specs(params, m, fsdp=fsdp)
    out = {}
    for (path, leaf), spec in zip(jax.tree_util.tree_leaves_with_path(params),
                                  jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        imap = NamedSharding(m, spec).addressable_devices_indices_map(leaf.shape)
        out["/".join(str(k.key) for k in path)] = [
            [(s.start or 0, leaf.shape[i] if s.stop is None else s.stop)
             for i, s in enumerate(imap[d])] for d in m.devices.flat]
    return out


def psum(n: int, grads: dict, errs: dict) -> tuple:
    m = mesh((n,), ("data",))
    spec = P("data")

    def body(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        og, oe = compression.psum_compressed(g, e, "data")
        return jax.tree.map(lambda x: x[None], og), jax.tree.map(lambda x: x[None], oe)

    fn = jax.jit(jax.shard_map(body, mesh=m, in_specs=(spec, spec), out_specs=(spec, spec),
                               check_vma=False))
    og, oe = fn(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, errs))
    return jax.tree.map(np.asarray, og), jax.tree.map(np.asarray, oe)


def compressed_dp(arch: str, leaves: dict, batches: list) -> dict:
    cfg = jconfigs.get(arch).reduced()
    params = params_from(cfg, leaves)
    m = mesh((2,), ("data",))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    state = TrainState(params, adamw_init(params), jnp.zeros((), jnp.int32),
                       compression.init_error_buffer(params))

    def exchanged(p, b):
        _, g = jax.value_and_grad(lambda q: jzoo.loss_fn(cfg, q, b, train=True)[0])(p)
        return compression.psum_compressed(g, compression.init_error_buffer(p), "data")[0]

    mean = jax.jit(jax.shard_map(exchanged, mesh=m, in_specs=(P(), P("data")),
                                 out_specs=P(), check_vma=False))(params, batches[0])
    step = make_compressed_dp_train_step(cfg, opt_cfg, m)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "mean_grads": flat(mean)}


def train_state(cfg, leaves: dict) -> TrainState:
    params = params_from(cfg, leaves)
    return TrainState(params, adamw_init(params), jnp.zeros((), jnp.int32))


def sharded_step(arch: str, leaves: dict, batch: dict, fsdp: bool) -> float:
    """The loss of the reference's ``jit_train_step`` on a (2, 2) mesh."""
    cfg = jconfigs.get(arch).reduced()
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    m = mesh((2, 2), ("data", "model"))
    act_sharding.set_mesh(m)
    try:
        step = jit_train_step(cfg, opt_cfg, m, train_state(cfg, leaves), batch, fsdp=fsdp)
        _, metrics = step(train_state(cfg, leaves), batch)
    finally:
        act_sharding.set_mesh(None)
    return float(metrics["loss"])


def unsharded_step(arch: str, leaves: dict, batch: dict) -> float:
    """The loss of the reference's unsharded jitted step."""
    cfg = jconfigs.get(arch).reduced()
    step = jax.jit(make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1)))
    return float(step(train_state(cfg, leaves), batch)[1]["loss"])


def main(inp: str, out: str) -> None:
    with open(inp, "rb") as f:
        job = pickle.load(f)
    res: dict = {"placements": {}, "psum": {}, "sharded": {}}
    for arch in job["archs"]:
        params = params_from(jconfigs.get(arch).reduced(), job["params"][arch])
        for fsdp in (False, True):
            res["placements"][arch, fsdp] = placements(params, fsdp)
    for n, (grads, errs) in job["psum"].items():
        res["psum"][n] = psum(n, grads, errs)
    arch = job["compressed_arch"]
    res["compressed"] = compressed_dp(arch, job["params"][arch], job["compressed_batches"])
    unsharded = {}
    for arch, fsdp in job["sharded_cases"]:
        leaves, batch = job["params"][arch], job["sharded_batch"][arch]
        if arch not in unsharded:
            unsharded[arch] = unsharded_step(arch, leaves, batch)
        res["sharded"][arch, fsdp] = {"loss": sharded_step(arch, leaves, batch, fsdp),
                                      "unsharded_loss": unsharded[arch]}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
