"""Quickstart on the PyTorch port: build a small ternary LM, train it
briefly, pack it to 2-bit T-SAR planes and generate text, the full loop in
one file (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py               # the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.device import resolve_device
from repro_torch.optim import OptConfig
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import init_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A reduced BitNet-style config (same family as the paper's models).
    cfg = configs.get("bitnet-2b-4t").reduced(n_layers=4, d_model=256, d_ff=512)
    print(f"model: {cfg.name}  ~{cfg.n_params()/1e6:.1f}M params, ternary={cfg.ternary}")

    # 2. Train with QAT (absmean ternarization + STE) on the synthetic stream.
    opt = OptConfig(lr=2e-3, warmup_steps=10, total_steps=200)
    state = init_state(cfg, torch.Generator(device=dev).manual_seed(0), opt, device=dev)
    step = make_train_step(cfg, opt)
    stream = SyntheticLMStream(DataConfig(cfg.vocab_size, 64, 8, seed=0))
    losses = []
    for i in range(60):
        state, metrics = step(state, stream.batch(i, device=dev))
        losses.append(float(metrics["loss"]))
        if i % 20 == 0:
            print(f"step {i:3d}  loss {losses[-1]:.3f}  "
                  f"lr {float(metrics['lr']):.2e}")

    # 3. Freeze to packed 2-bit planes and serve (T-SAR inference path).
    engine = ServingEngine(cfg, state.params, max_len=96, batch_slots=2,
                           packed=True, device=dev)
    reqs = [Request(uid=i, prompt=np.arange(8) + i, max_new_tokens=12)
            for i in range(3)]
    engine.run(reqs)
    for r in reqs:
        print(f"req {r.uid}: {r.out_tokens}")
    print(f"decode throughput: {engine.throughput():.1f} tok/s "
          f"(packed 2-bit weights)")
    return {"losses": losses, "requests": reqs, "engine": engine}


if __name__ == "__main__":
    main()
