"""Training driver (port of ``repro/launch/train.py``).

Config resolution (``--arch``), the synthetic data pipeline, the train
step (``--remat``, ``--accum-steps``), checkpoints every ``--ckpt-every``
steps with auto-resume from the latest, supervision with restarts, a
heartbeat file and straggler reports, and the int8 error-feedback gradient
mean (``--compress-grads``, one process).  Runs on the GPU unless
``--device cpu``; ``--smoke`` trains the reduced config (sequence 64,
batch 8 by default).  Weights start from seed 0: nothing is downloaded.

    PYTHONPATH=src python -m repro_torch.launch.train --arch bitnet-2b-4t \
        --smoke --steps 20 --device cpu

The reference's mesh layouts (``--mesh single|multi``, ``--fsdp``) and the
compressed all-reduce across processes come with the multi-device slice
(ROADMAP.md, Queue 1, item 10): those flags raise.
"""
from __future__ import annotations

import argparse
import os

import torch

import repro_torch.configs as configs
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig, compression
from repro_torch.runtime import Heartbeat, StepMonitor, run_with_restarts
from repro_torch.train import init_state, make_compressed_dp_train_step, make_train_step

_LATER = "is not ported yet; it comes with the multi-device slice (ROADMAP.md, Queue 1, item 10)"


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
                    help="int8 error-feedback data-parallel gradient mean (one process)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh} {_LATER}")
    if args.fsdp:
        raise NotImplementedError(f"--fsdp {_LATER}")
    n_proc = max(compression.world_size(), int(os.environ.get("WORLD_SIZE", "1")))
    if args.compress_grads and n_proc > 1:
        raise NotImplementedError(f"--compress-grads over {n_proc} processes {_LATER}")
    dev = resolve_device(args.device)

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
    os.makedirs(ckdir, exist_ok=True)

    if args.compress_grads:
        step_fn = make_compressed_dp_train_step(cfg, opt_cfg, remat=args.remat)
    else:
        step_fn = make_train_step(cfg, opt_cfg, remat=args.remat,
                                  accum_steps=args.accum_steps)

    def restore_fn():
        target = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt_cfg,
                            compressed=args.compress_grads, device=dev)
        latest = ckpt.latest_step(ckdir)
        if latest is None:
            return target, 0
        print(f"[train] resuming from step {latest}")
        return ckpt.restore(ckdir, latest, target), latest

    def body(state, start):
        it = PrefetchIterator(stream, start_step=start, device=dev)
        saving = None
        try:
            for _ in range(start, args.steps):
                i, batch = next(it)
                monitor.start(i)
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])           # waits for the step
                dt = monitor.stop()
                hb.beat(i)
                if monitor.is_straggler(dt):
                    print(f"[straggler] step {i} took {dt:.2f}s "
                          f"(median {monitor.median():.2f}s)")
                if (i + 1) % args.ckpt_every == 0 or (i + 1) == args.steps:
                    if saving is not None:
                        saving.wait()
                    saving = ckpt.save(ckdir, i + 1, state, async_save=True)
                if i % 10 == 0:
                    print(f"step {i:5d}  loss {loss:.4f}  "
                          f"gnorm {float(metrics['grad_norm']):.2f}  {dt * 1e3:.0f} ms")
        finally:
            it.close()
            if saving is not None:
                saving.wait()
        return args.steps

    report = run_with_restarts(body, restore_fn=restore_fn, max_restarts=args.max_restarts)
    print(f"[train] completed={report.completed} restarts={report.restarts} "
          f"last_step={report.last_step}")
    return 0 if report.completed else 1


if __name__ == "__main__":
    raise SystemExit(main())
