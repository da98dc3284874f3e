"""Fault-tolerant training on the PyTorch port (the counterpart of
``examples/train_resume.py``): checkpointed QAT training with a simulated
mid-run failure, automatic restore, and continuation from the checkpoint.

    PYTHONPATH=src python examples/torch_train_resume.py [--device cpu]
"""
import argparse
import tempfile

import torch

import repro_torch.configs as configs
from repro_torch import checkpoint as ckpt
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig
from repro_torch.runtime import StepMonitor, run_with_restarts
from repro_torch.train import init_state, make_train_step

STEPS = 24
CKPT_EVERY = 4


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get("gemma2-2b").reduced()
    opt = OptConfig(lr=1e-3, warmup_steps=5, total_steps=STEPS)
    step = make_train_step(cfg, opt, accum_steps=2)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 32, 8, seed=11))
    ckdir = tempfile.mkdtemp(prefix="tsar_ckpt_")
    monitor = StepMonitor()
    crash = {"armed": True}

    def restore_fn():
        target = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt,
                            device=dev)
        latest = ckpt.latest_step(ckdir)
        if latest is None:
            print("[restore] cold start")
            return target, 0
        print(f"[restore] resuming from checkpoint step {latest}")
        return ckpt.restore(ckdir, latest, target), latest

    def body(state, start):
        saving = None
        try:
            for i in range(start, STEPS):
                if i == 13 and crash["armed"]:
                    crash["armed"] = False
                    raise RuntimeError("simulated node failure at step 13")
                monitor.start(i)
                state, m = step(state, stream.batch(i, device=dev))
                loss = float(m["loss"])            # waits for the step
                dt = monitor.stop()
                if (i + 1) % CKPT_EVERY == 0:
                    if saving is not None:
                        saving.wait()
                    saving = ckpt.save(ckdir, i + 1, state, async_save=True)
                print(f"step {i:2d} loss {loss:.3f} ({dt*1e3:.0f} ms)"
                      + ("  [straggler]" if monitor.is_straggler(dt) else ""))
        finally:
            if saving is not None:
                saving.wait()
        return STEPS

    report = run_with_restarts(body, restore_fn=restore_fn, max_restarts=2)
    print(f"\ncompleted={report.completed} after {report.restarts} restart(s); "
          f"failures={report.failures}")
    print(f"median step time {monitor.median()*1e3:.0f} ms; "
          f"straggler steps: {monitor.straggler_steps}")
    return report


if __name__ == "__main__":
    main()
