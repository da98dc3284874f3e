"""Several gloo ranks on the CPU for the port's multi-process tests.

:func:`run_ranks` starts ``n`` spawned processes that join one gloo
process group through a file in the test's directory (so parallel test
workers never share a port), each on one torch thread, runs a function of
this module on every rank and returns what each rank returned.  A rank
that fails fails the call at once (the others are killed), and the whole
call has its own timeout, so a hung collective fails its test instead of
running out the suite's time.

The rank functions import torch and the port only: the reference runs in
its own subprocess (``tests/_jax_mesh_ref.py``).
"""
from __future__ import annotations

import os
import time
import traceback
import uuid

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 120.0


def run_ranks(fn, n: int, workdir, *args, timeout: float = TIMEOUT_S) -> list:
    """``fn(rank, n, *args)`` on ``n`` gloo ranks; the list of the ranks'
    return values (``torch.save``-able)."""
    tag = uuid.uuid4().hex[:8]
    root = os.path.join(str(workdir), f"ranks_{fn.__name__}_{n}_{tag}")
    os.makedirs(root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, n, root, args), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {fn.__name__} failed:\n"
                                   + _err(root, failed[0]))
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {n} ranks passed {timeout} s")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {fn.__name__} exited {p.exitcode}:\n"
                                   + _err(root, r))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(os.path.join(root, f"out{r}.pt"), weights_only=False)
            for r in range(n)]


def _err(root: str, rank: int) -> str:
    path = os.path.join(root, f"err{rank}.txt")
    return open(path).read() if os.path.exists(path) else "(no traceback written)"


def _entry(fn, rank: int, n: int, root: str, args: tuple) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    try:
        mesh.init_process_group("cpu", init_method=f"file://{root}/store", rank=rank,
                                world_size=n)
        out = fn(rank, n, *args)
        torch.save(out, os.path.join(root, f"out{rank}.pt"))
        dist.barrier()
    except BaseException:
        with open(os.path.join(root, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Shared inputs
# ---------------------------------------------------------------------------

def reduced(arch: str, **overrides):
    import repro_torch.configs as configs

    return configs.get(arch).reduced(**overrides)


def port_params(arch: str) -> dict:
    """Reduced latent params of the port, drawn from seed 0."""
    from repro_torch.models import model_zoo

    return model_zoo.init_params(reduced(arch), torch.Generator().manual_seed(0), "cpu")


def flat(tree, path=()) -> dict:
    """``{"a/b/c": numpy leaf}`` of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in flat(sub, path + (k,)).items()}
    t = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
    return {"/".join(path): t.detach().cpu().numpy()}


def unflat(leaves: dict) -> dict:
    """The nested dict of tensors of :func:`flat`'s form."""
    out: dict = {}
    for key, arr in leaves.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr))
    return out


def lm_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).long(),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).long()}


def mesh22(n: int):
    from repro_torch.launch import mesh as mesh_lib

    dims = (2, 2) if n == 4 else (1, n)
    return mesh_lib.device_mesh(mesh_lib.make_mesh(dims, ("data", "model")), "cpu")


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------

def placement_shards(rank: int, n: int, archs: tuple) -> dict:
    """Each rank's local shard of every leaf, per (arch, fsdp); and the
    leaves where ``sharding.local_shard`` of the full leaf differs from the
    placed DTensor's local tensor (none expected)."""
    from repro_torch.train import sharding

    dm = mesh22(n)
    out = {"local_shard_differs": []}
    for arch in archs:
        params = port_params(arch)
        for fsdp in (False, True):
            placed = sharding.place(params, dm, sharding.param_specs(params, dm, fsdp=fsdp))
            out[arch, fsdp] = _local_flat(placed)
            full = flat(params)
            for key, leaf in _flat_tensors(placed).items():
                view = sharding.local_shard(torch.from_numpy(full[key]), dm, leaf.placements)
                if not torch.equal(view, leaf.to_local()):
                    out["local_shard_differs"].append((arch, fsdp, key))
    return out


def _flat_tensors(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat_tensors(sub, path + (k,)).items()}
    return {"/".join(path): tree}


def _local_flat(tree) -> dict:
    return {k: v.to_local().numpy().copy() for k, v in _flat_tensors(tree).items()}


def psum_rank(rank: int, n: int, grads: dict, errs: dict) -> tuple:
    """``psum_compressed`` of this rank's grads and error buffers."""
    from repro_torch.optim import compression

    g = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    e = {k: torch.from_numpy(v[rank]) for k, v in errs.items()}
    got_g, got_e = compression.psum_compressed(g, e)
    return ({k: v.numpy() for k, v in got_g.items()}, {k: v.numpy() for k, v in got_e.items()})


def compressed_dp_rank(rank: int, n: int, arch: str, params: dict, batches: list) -> dict:
    """Two steps of ``make_compressed_dp_train_step`` over the world from
    ``params``, and the exchanged mean gradient of the first step."""
    from repro_torch.optim import OptConfig, adamw_init, compression
    from repro_torch.train import TrainState, loss_and_grads, make_compressed_dp_train_step
    from repro_torch.train.train_loop import _rows

    cfg = reduced(arch)
    p = unflat(params)
    local = _rows(batches[0], rank, n)
    _, _, grads = loss_and_grads(cfg, p, local)
    mean, _ = compression.psum_compressed(grads, compression.init_error_buffer(p))
    state = TrainState(p, adamw_init(p), torch.zeros((), dtype=torch.int32),
                       compression.init_error_buffer(p))
    step = make_compressed_dp_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=1))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": losses, "mean_grads": flat(mean)}


def jit_step_rank(rank: int, n: int, archs: tuple, cases: tuple, params: dict,
                  batch: dict, ckpt_dir: str) -> dict:
    """This rank's shards of the seeded params of ``archs``
    (:func:`placement_shards`), and per (arch, fsdp) case: one
    ``jit_train_step`` step on the (2, 2) mesh from the given params, its
    loss, the averaged gradients, whether the state came back in its input
    placements, and the one-process step's loss and gradients; the
    gradients' all-to-alls of the MoE layers, the all-gathers of a 3-D leaf
    (a layer's expert stack) along its first dimension over 'model', and
    the relative L2 distance of this rank's shard of each routed-expert
    gradient from its slice of the one-process gradient.  The bitnet fsdp
    state after its step is saved to ``ckpt_dir``."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.models import moe
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import TrainState, fsdp as fsdp_lib, jit_train_step, loss_and_grads
    from repro_torch.train import sharding
    from repro_torch.train.train_loop import sharded_loss_and_grads

    dm = mesh22(n)
    out = {"shards": placement_shards(rank, n, archs)}
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=1)
    model_group = dm.get_group("model")
    gather_dim = fsdp_lib._gather_dim
    expert_gathers = []

    def watched(t, dim, size, group):
        if t.ndim == 3 and dim == 0 and group is model_group:
            expert_gathers.append(tuple(t.shape))
        return gather_dim(t, dim, size, group)

    for arch, fsdp in cases:
        cfg = reduced(arch)
        p = unflat(params[arch])
        state = TrainState(p, adamw_init(p), torch.zeros((), dtype=torch.int32))
        step = jit_train_step(cfg, opt_cfg, dm, state, batch[arch], fsdp=fsdp)
        placed = step.place(state)
        before = _placements(placed)
        moe.EP_CALLS["all_to_all"] = 0
        expert_gathers.clear()
        fsdp_lib._gather_dim = watched
        try:
            loss_s, _, grads_s = sharded_loss_and_grads(cfg, dm, placed, batch[arch],
                                                        step.batch_specs)
        finally:
            fsdp_lib._gather_dim = gather_dim
        a2a, gathers = moe.EP_CALLS["all_to_all"], list(expert_gathers)
        new, metrics = step(placed, batch[arch])
        res = {"loss": float(metrics["loss"]), "sharded_grads_loss": float(loss_s),
               "grads": flat(grads_s), "same_placements": _placements(new) == before,
               "all_to_all": a2a, "expert_gathers_over_model": gathers}
        if rank == 0 or cfg.is_moe:
            loss1, _, grads1 = loss_and_grads(cfg, unflat(params[arch]), batch[arch])
            res.update(loss_one=float(loss1), grads_one=flat(grads1))
        if cfg.is_moe:
            res["expert_shard_rel"] = {
                key: _rel_l2(g.to_local(), sharding.local_shard(
                    torch.from_numpy(res["grads_one"][key]), dm, g.placements))
                for key, g in _flat_tensors(grads_s).items()
                if sharding.is_expert_stack(tuple(key.split("/")), g.ndim)}
        if rank != 0:
            res.pop("grads_one", None)
        out[arch, fsdp] = res
        if arch == "bitnet-2b-4t" and fsdp:
            ckpt.save(ckpt_dir, 1, new)
            out["saved"] = flat(new.params)
    out["liveness"] = gathered_liveness(dm)
    return out


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))


def gathered_liveness(dm) -> dict:
    """The most elements of whole params gathered and alive at once during
    the fsdp gradients of a 4-layer reduced bitnet-2b-4t, with and without
    ``remat``; beside the elements of one layer's params, of the params
    outside the layer stack and of all of them, and whether every
    gradient shard has its param shard's shape."""
    import dataclasses
    import weakref

    from repro_torch.models import model_zoo
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import TrainState, fsdp, jit_train_step
    from repro_torch.train.train_loop import sharded_loss_and_grads

    cfg = dataclasses.replace(reduced("bitnet-2b-4t"), n_layers=4)
    p = model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = TrainState(p, adamw_init(p), torch.zeros((), dtype=torch.int32))
    batch = lm_batch(cfg, 4, 8, 1)
    step = jit_train_step(cfg, OptConfig(), dm, state, batch, fsdp=True)
    placed = step.place(state)
    alive: list = []
    peak = [0]
    real = fsdp.Split.all_gather

    def counted(self, local, placements, keep=()):
        out = real(self, local, placements, keep)
        if out.untyped_storage().data_ptr() != local.untyped_storage().data_ptr():
            alive.append((weakref.ref(out), out.numel()))
            peak[0] = max(peak[0], sum(n for r, n in alive if r() is not None))
        return out

    res = {}
    fsdp.Split.all_gather = counted
    try:
        for remat in (True, False):
            alive.clear()
            peak[0] = 0
            _, _, grads = sharded_loss_and_grads(cfg, dm, placed, batch, step.batch_specs,
                                                 remat=remat)
            res[remat] = peak[0]
    finally:
        fsdp.Split.all_gather = real
    sizes = {k: v.numel() for k, v in _flat_tensors(p).items()}
    res["layer"] = sum(n for k, n in sizes.items() if k.startswith("blocks/")) // cfg.n_layers
    res["top"] = sum(n for k, n in sizes.items() if not k.startswith("blocks/"))
    res["all"] = sum(sizes.values())
    res["shard_shapes"] = all(
        g.to_local().shape == w.to_local().shape
        for g, w in zip(_flat_tensors(grads).values(), _flat_tensors(placed.params).values()))
    return res


def _placements(state) -> list:
    from repro_torch.checkpoint.checkpointing import _flatten

    return [(k, tuple(v.placements)) for k, v in _flatten(state).items()]


def restore_rank(rank: int, n: int, ckpt_dir: str) -> dict:
    """The checkpoint restored onto this world's mesh, leaf by leaf."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_state, jit_train_step

    cfg = reduced("bitnet-2b-4t")
    dm = mesh22(n)
    target = init_state(cfg, torch.Generator().manual_seed(1), OptConfig(), device="cpu")
    batch = lm_batch(cfg, 4, 8, 0)
    step = jit_train_step(cfg, OptConfig(), dm, target, batch, fsdp=True)
    got = ckpt.restore(ckpt_dir, 1, target, shardings=step.shardings)
    return {"params": flat(got.params), "placements": _placements(got)}


def train_cli_rank(rank: int, n: int, argv: list) -> int:
    """``launch/train.py`` on this rank of the world."""
    from repro_torch.launch import train as train_main

    return train_main.main(argv)


def serving_rank(rank: int, n: int, arch: str, prompt_len: int, steps: int,
                 overrides: dict | None = None, dims: tuple | None = None) -> dict:
    """Prefill and ``steps`` greedy decode steps of the frozen reduced
    ``arch`` (with config ``overrides``) through ``dryrun.mesh_cells`` on
    the (2, 2) mesh (or a ('data', 'model') mesh of ``dims``), beside the
    unsharded ``prefill`` / ``decode_step`` on the same params; the (N, K,
    M) of every call of ``tsar_matmul``'s wrapper on the mesh path (on the
    CPU it takes the plain version, and ``LAUNCHES`` counts only kernel
    launches), the expert-parallel calls, and the query heads of every call
    of the attention core (``layers.attend_core``) on the mesh path."""
    from repro_torch.kernels import tsar_matmul
    from repro_torch.launch import dryrun
    from repro_torch.models import layers, model_zoo, moe
    from repro_torch.serving.engine import freeze_params

    cfg = reduced(arch, **(overrides or {}))
    params = freeze_params(model_zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                           sparse=False)
    b, max_len = 2, prompt_len + steps + 1
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, prompt_len))).long()}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32))

    def greedy(prefill, decode, cache):
        logits, cache = prefill(batch, cache)
        out = [logits]
        for t in range(prompt_len, prompt_len + steps):
            logits, cache = decode(out[-1].argmax(-1), cache, t)
            out.append(logits)
        return out

    plain = greedy(lambda bt, c: model_zoo.prefill(cfg, params, bt, c),
                   lambda tk, c, t: model_zoo.decode_step(cfg, params, tk, c, t),
                   model_zoo.init_cache(cfg, b, max_len, torch.float32, "cpu"))
    if dims is None:
        dm = mesh22(n)
    else:
        from repro_torch.launch import mesh as mesh_lib

        dm = mesh_lib.device_mesh(mesh_lib.make_mesh(dims, ("data", "model")), "cpu")
    cells = dryrun.mesh_cells(cfg, params, dm)
    moe.EP_CALLS["expert_parallel"] = 0
    calls: list = []
    wrapper = tsar_matmul.tsar_matmul_packed

    def recorded(a_q, a_scale, sign, zero, w_scale):
        calls[-1].append((a_q.shape[0], a_q.shape[1], sign.shape[1]))
        return wrapper(a_q, a_scale, sign, zero, w_scale)

    def step(fn):
        def run(*a):
            calls.append([])
            return fn(*a)
        return run

    split_calls = [0]
    attend_split = layers.attend_split

    def counted_split(*a, **kw):
        split_calls[0] += 1
        return attend_split(*a, **kw)

    core_heads: list = []
    attend_core = layers.attend_core

    def counted_core(cfg_, qg, *a):
        core_heads.append(qg.shape[2] * qg.shape[3])          # (B, Sq, Hk, G, Dh)
        return attend_core(cfg_, qg, *a)

    tsar_matmul.tsar_matmul_packed, layers.attend_split = recorded, counted_split
    layers.attend_core = counted_core
    try:
        mesh = greedy(step(cells.prefill), step(cells.decode_step), cells.place_cache(
            model_zoo.init_cache(cfg, b, max_len, torch.float32, "cpu")))
    finally:
        tsar_matmul.tsar_matmul_packed, layers.attend_split = wrapper, attend_split
        layers.attend_core = attend_core
    return {"plain": [t.numpy() for t in plain], "mesh": [t.numpy() for t in mesh],
            "calls": calls, "ep_calls": moe.EP_CALLS["expert_parallel"],
            "split_kv_calls": split_calls[0], "core_heads": core_heads}


def split_attention_rank(rank: int, n: int) -> dict:
    """``layers.attend_split`` over this rank's block of 12 key positions
    (float64 and float32 contexts, softcap on), and ``attend_core`` over all
    of them on the same numpy-seeded inputs: query rows 0-3 see every
    position, rows 4-5 only the first block (the others' blocks wholly
    masked), row 6 none (masked everywhere)."""
    import dataclasses
    import torch.distributed as dist

    from repro_torch.models import layers

    cfg = dataclasses.replace(reduced("bitnet-2b-4t"), attn_softcap=30.0)
    rng = np.random.default_rng(5)
    b, s, hk, g, dh, t = 2, 7, 2, 2, 8, 12
    qg = torch.from_numpy(rng.standard_normal((b, s, hk, g, dh)))
    k = torch.from_numpy(rng.standard_normal((b, t, hk, dh)))
    v = torch.from_numpy(rng.standard_normal((b, t, hk, dh)))
    mask = torch.ones((1, 1, 1, s, t), dtype=torch.bool)
    mask[..., 4:6, t // n:] = False
    mask[..., 6, :] = False
    tb = t // n
    blk = slice(rank * tb, (rank + 1) * tb)
    out = {}
    for dtype in (torch.float64, torch.float32):
        out[str(dtype)] = {
            "split": layers.attend_split(cfg, qg, k[:, blk], v[:, blk], mask[..., blk], dtype,
                                         (dist.group.WORLD,)).numpy(),
            "whole": layers.attend_core(cfg, qg, k, v, mask, dtype).numpy()}
    return out


def train_mesh_rank(rank: int, n: int, argv: list) -> dict:
    """``launch/train.py --mesh single`` on this world with the production
    mesh swapped for a (1, n) one; counts the steps run through
    ``jit_train_step``'s step."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as train_main

    steps = [0]
    real = train_main.jit_train_step

    def counted(*a, **kw):
        step = real(*a, **kw)

        def run(state, batch):
            steps[0] += 1
            return step(state, batch)

        run.shardings = step.shardings
        return run

    train_main.jit_train_step = counted
    make = mesh_lib.make_production_mesh
    mesh_lib.make_production_mesh = lambda multi_pod=False: mesh_lib.make_mesh(
        (1, n), ("data", "model"))
    try:
        rc = train_main.main(argv)
    finally:
        train_main.jit_train_step, mesh_lib.make_production_mesh = real, make
    return {"rc": rc, "jit_steps": steps[0]}


def _materialized(tree, vocab: int, rng: np.random.Generator):
    """Real CPU tensors of a meta tree's shapes and dtypes: token ids below
    ``vocab`` for integer leaves, zeros for the rest (caches, stubs)."""
    if isinstance(tree, dict):
        return {k: _materialized(v, vocab, rng) for k, v in tree.items()}
    if tree.dtype.is_floating_point:
        return torch.zeros(tree.shape, dtype=tree.dtype)
    return torch.from_numpy(rng.integers(0, vocab, tuple(tree.shape))).to(tree.dtype)


# The dry-run cells held against real ranks on (2, 2): name -> (arch,
# (shape fields), kwargs of ``dryrun.lower_cell``, overrides of the reduced
# config).  ``moe_train_fsdp`` keeps its experts split on 'model' (4 experts
# over 2 ranks: tokens by all-to-all); ``splitkv_decode`` has one KV head,
# so its cache splits on its sequence over 'model'.
DRYRUN_CELLS = {
    "bitnet_decode": ("bitnet-2b-4t", ("d", 32, 4, "decode"), {}, {}),
    "bitnet_prefill": ("bitnet-2b-4t", ("p", 32, 4, "prefill"), {}, {}),
    "moe_decode": ("deepseek-moe-16b", ("d", 32, 4, "decode"), {}, {}),
    "bitnet_train": ("bitnet-2b-4t", ("t", 32, 4, "train"), {"fsdp": False}, {}),
    "bitnet_train_fsdp": ("bitnet-2b-4t", ("t", 32, 4, "train"), {"fsdp": True}, {}),
    "moe_train_fsdp": ("deepseek-moe-16b", ("t", 32, 4, "train"), {"fsdp": True}, {}),
    "splitkv_decode": ("bitnet-2b-4t", ("d", 32, 4, "decode"), {}, {"n_kv_heads": 1}),
}


def fake_world_counts(name: str, device_type: str = "cuda", rank: int = 0) -> dict:
    """The dry-run's per-device counts of ``DRYRUN_CELLS[name]`` on (2, 2),
    traced as ``rank`` of a fake world of ``device_type``: FLOPs, kernel
    operations and calls by kernel, collective bytes by kind."""
    import repro_torch.configs as configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh

    arch, fields, kw, overrides = DRYRUN_CELLS[name]
    mesh = make_mesh((2, 2), ("data", "model"))
    with fake_world(mesh, device_type, rank) as dm:
        lowered, _ = dryrun.lower_cell(reduced(arch, **overrides),
                                       configs.ShapeConfig(*fields), mesh, device_mesh=dm, **kw)
        m = dryrun.measure(lowered, mesh)
    return {"flops": m["counts"]["flops"], "kernel_ops": m["counts"]["kernel_ops"],
            "kernels": m["kernels"], "collectives": m["collectives"]}


def dryrun_counts_rank(rank: int, n: int, cells: dict) -> dict:
    """Per cell of ``cells`` (name -> (arch, (shape fields), kwargs of
    ``dryrun.lower_cell``)): the dry-run's counter (``dryrun.MetaTrace`` and
    the kernel tally) around this rank's share of the same step on real
    tensors of the reduced config, on the (2, 2) mesh of this gloo world:
    the serve cells through ``dryrun.mesh_cells``, the train cell through
    ``jit_train_step``, built as ``lower_cell`` builds them.  On the CPU a
    kernel wrapper takes the plain version, whose ops are not the kernel's:
    here each call runs with the trace paused, and once more on meta copies
    of its inputs so that its meta branch tallies it as on the dry-run."""
    from torch.utils._python_dispatch import _disable_current_modes

    import repro_torch.configs as configs
    from repro_torch.kernels import tally, tsar_matmul
    from repro_torch.launch import dryrun
    from repro_torch.models import model_zoo, moe
    from repro_torch.optim import OptConfig
    from repro_torch.serving.engine import freeze_params
    from repro_torch.train import init_state, jit_train_step

    dm = mesh22(n)
    real = tsar_matmul.tsar_matmul_packed

    def paused(*args):
        with _disable_current_modes():
            real(*(a.to("meta") for a in args))
            return real(*args)

    out = {}
    tsar_matmul.tsar_matmul_packed = paused
    try:
        for name, (arch, fields, kw, overrides) in cells.items():
            cfg, shape = reduced(arch, **overrides), configs.ShapeConfig(*fields)
            rng = np.random.default_rng(0)
            gen = torch.Generator().manual_seed(0)
            inputs = _materialized(model_zoo.input_specs(cfg, shape), cfg.vocab_size, rng)
            if shape.kind == "train":
                opt_cfg = OptConfig(moment_dtype="bfloat16" if cfg.n_params() > dryrun.BIG_PARAMS
                                    else "float32")
                state = init_state(cfg, gen, opt_cfg, device="cpu")
                step = jit_train_step(cfg, opt_cfg, dm, state, inputs, remat=True,
                                      fsdp=kw.get("fsdp", True))
                placed = step.place(state)
                run = lambda: step(placed, inputs)  # noqa: E731
            else:
                params = freeze_params(model_zoo.init_params(cfg, gen, "cpu"), sparse=False)
                cells_ = dryrun.mesh_cells(cfg, params, dm,
                                           fsdp=dryrun.serve_fsdp(cfg, dm, "packed"))
                cache = cells_.place_cache(inputs.pop("cache"))
                if shape.kind == "prefill":
                    run = lambda: cells_.prefill(inputs, cache)  # noqa: E731
                else:
                    run = lambda: cells_.decode_step(inputs["tokens"], cache,  # noqa: E731
                                                     shape.seq_len - 1)
            moe.EP_CALLS["expert_parallel"] = 0
            trace = dryrun.MetaTrace(set())
            del tally.TALLY[:]
            with trace:
                run()
            out[name] = {"flops": float(trace.flops), "kernel_ops": float(tally.ops()),
                         "kernels": tally.counts(),
                         "collectives": {k: float(v) for k, v in trace.collectives.items()},
                         "ep_calls": moe.EP_CALLS["expert_parallel"]}
            del tally.TALLY[:]
    finally:
        tsar_matmul.tsar_matmul_packed = real
    return out
