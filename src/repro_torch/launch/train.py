"""Training driver (port of ``repro/launch/train.py``).

Config resolution (``--arch``), the synthetic data pipeline, the train
step (``--remat``, ``--accum-steps``), checkpoints every ``--ckpt-every``
steps with auto-resume from the latest, supervision with restarts, a
heartbeat file and straggler reports.  Runs on the GPU unless ``--device
cpu``; ``--smoke`` trains the reduced config (sequence 64, batch 8 by
default).  Weights start from seed 0: nothing is downloaded.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bitnet-2b-4t \
        --smoke --steps 20 --device cpu

Across processes it runs under ``torchrun``, one process per card (NCCL)
or, with ``--device cpu``, per CPU rank (gloo):

* ``--compress-grads``: data parallel over the whole world with the int8
  error-feedback gradient mean (the reference's ``jax.device_count()``
  data mesh);
* ``--mesh single|multi``: the production mesh (16 x 16, or 2 x 16 x 16)
  over the world, which must hold exactly its 256 (512) processes, and the
  step of ``train.jit_train_step`` (``--fsdp`` shards the state over the
  data axes as well).  Without a mesh ``--fsdp`` has no effect, as in the
  reference.

Only rank 0 prints, writes checkpoints and beats the heartbeat.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch bitnet-2b-4t \
        --smoke --steps 20 --device cpu --compress-grads
"""
from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import OptConfig
from repro_torch.runtime import Heartbeat, StepMonitor, run_with_restarts
from repro_torch.train import (init_state, jit_train_step, make_compressed_dp_train_step,
                               make_train_step)
from repro_torch.utils import act_sharding


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--mesh", choices=["none", "single", "multi"], default="none",
                    help="'none' = the one device of --device")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback data-parallel gradient mean over the world")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if args.mesh != "none":
        mesh = mesh_lib.make_production_mesh(multi_pod=args.mesh == "multi")
        if world != mesh.size:
            raise ValueError(f"--mesh {args.mesh} is a {mesh.size}-process mesh "
                             f"{dict(mesh.shape)}; this world has {world} processes")
    if world > 1 or args.mesh != "none":
        dev = mesh_lib.init_process_group(dev)
    device_mesh = None
    if args.mesh != "none":
        device_mesh = mesh_lib.device_mesh(mesh, dev)
        act_sharding.set_mesh(device_mesh)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    seq = args.seq_len or (64 if args.smoke else 4096)
    gb = args.global_batch or (8 if args.smoke else 256)

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                        total_steps=args.steps)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, seq, gb))
    ckdir = os.path.join(args.ckpt_dir, cfg.name)
    monitor = StepMonitor()
    hb = Heartbeat(os.path.join(ckdir, "heartbeat.json"))
    if lead:
        os.makedirs(ckdir, exist_ok=True)

    def build_step(state):
        if args.compress_grads:
            return make_compressed_dp_train_step(cfg, opt_cfg, remat=args.remat)
        if device_mesh is not None:
            return jit_train_step(cfg, opt_cfg, device_mesh, state, stream.batch(0, device=dev),
                                  fsdp=args.fsdp, remat=args.remat,
                                  accum_steps=args.accum_steps)
        return make_train_step(cfg, opt_cfg, remat=args.remat, accum_steps=args.accum_steps)

    def restore_fn():
        target = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg,
                            compressed=args.compress_grads, device=dev)
        if dist.is_initialized():      # every rank agrees on the step to resume
            dist.barrier()
        latest = ckpt.latest_step(ckdir)
        if latest is None:
            return target, 0
        if lead:
            print(f"[train] resuming from step {latest}")
        shardings = (build_step(target).shardings if device_mesh is not None
                     and not args.compress_grads else None)
        return ckpt.restore(ckdir, latest, target, shardings=shardings), latest

    def body(state, start):
        step_fn = build_step(state)
        it = PrefetchIterator(stream, start_step=start, device=dev)
        saving = None
        try:
            for _ in range(start, args.steps):
                i, batch = next(it)
                monitor.start(i)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])           # waits for the step
                dt = monitor.stop()
                if lead:
                    hb.beat(i)
                if lead and monitor.is_straggler(dt):
                    print(f"[straggler] step {i} took {dt:.2f}s "
                          f"(median {monitor.median():.2f}s)")
                if (i + 1) % args.ckpt_every == 0 or (i + 1) == args.steps:
                    if saving is not None:
                        saving.wait()
                    # Every rank gathers a sharded state; rank 0 writes.
                    saving = ckpt.save(ckdir, i + 1, state, async_save=True)
                if lead and i % 10 == 0:
                    print(f"step {i:5d}  loss {loss:.4f}  "
                          f"gnorm {float(metrics['grad_norm']):.2f}  {dt * 1e3:.0f} ms")
        finally:
            it.close()
            if saving is not None:
                saving.wait()
        return args.steps

    report = run_with_restarts(body, restore_fn=restore_fn, max_restarts=args.max_restarts)
    if dist.is_initialized():
        dist.barrier()                  # rank 0's last checkpoint is on disk
    if lead:
        print(f"[train] completed={report.completed} restarts={report.restarts} "
              f"last_step={report.last_step}")
    act_sharding.set_mesh(None)
    return 0 if report.completed else 1


if __name__ == "__main__":
    raise SystemExit(main())
