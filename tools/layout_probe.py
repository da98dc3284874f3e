#!/usr/bin/env python3
"""Does a token get the same bits in every step layout?  A probe of the
attention core and rmsnorm on one GPU.

    python3 tools/layout_probe.py

The serving policies batch one token's query with different neighbours:
T flat tokens (``flat``), B x C chunk rows (``chunked``), a whole prompt
(``whole``).  Greedy tokens stay equal across policies only if the token's
attention context and norm rows come out bit-identical in each.  This
probe takes one query at position 76 of slot 0 (a (4, 256) cache view,
``bitnet-2b-4t`` heads: 5 KV heads x 4 queries each x 128) and computes its
context in each layout, per formulation:

* ``f32 flattened``: float32, the flat step's tokens over the whole view
  flattened to B x Vtok keys under a segment mask (the reference's flat
  layout), a whole prompt over its own keys;
* ``f32 per-slot``: float32, every query over its own slot's Vtok key row;
* ``f64 flattened`` / ``f64 per-slot``: the same with scores, softmax and
  the weighted sum in float64, rounded once to float32.

Layouts: flat T = 4, 20, 64; chunked 4 x 16 (rows 0 and 9) and 4 x 1; a
whole prompt of 77 and 128.  Each formulation prints whether every layout
equals the flat T = 4 one, and the largest difference.  Then rmsnorm over
d 2560, its mean square summed in float32 and in float64: how many rows of
a call of each step shape differ from the same row normed alone; then the
flat decode core's time per layer (CUDA events, 100 calls).  Random inputs
from generator seed 0; TF32 off.
"""
from __future__ import annotations

import math
import subprocess
import sys

HK, GQ, DH, VTOK, SLOTS, POS = 5, 4, 128, 256, 4, 76


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("layout_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def core(q, k, v, valid, dtype):
        """q (b, s, Hk, G, Dh) against k/v (b, T, Hk, Dh) under valid (b, s, T)."""
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        sc = torch.einsum("bshgd,bthd->bhgst", q, k) / math.sqrt(DH)
        sc = torch.where(valid[:, None, None], sc, torch.finfo(sc.dtype).min)
        probs = torch.softmax(sc, dim=-1)
        return torch.einsum("bhgst,bthd->bshgd", probs, v).to(torch.float32)

    def flat(qt, ck, cv, slot, pos, dtype, per_slot):
        kpos = torch.arange(VTOK, device=dev)
        if per_slot:
            valid = (kpos[None] <= pos[:, None])[:, None]
            return core(qt[:, None], ck[slot], cv[slot], valid, dtype)[:, 0]
        t = ck.shape[0] * VTOK
        kidx = torch.arange(t, device=dev)
        valid = ((kidx // VTOK)[None] == slot[:, None]) & ((kidx % VTOK)[None] <= pos[:, None])
        return core(qt[None], ck.reshape(1, t, HK, DH), cv.reshape(1, t, HK, DH),
                    valid[None], dtype)[0]

    ck, cv = rnd(SLOTS, VTOK, HK, DH), rnd(SLOTS, VTOK, HK, DH)
    target = rnd(HK, GQ, DH)
    for name, dtype, per_slot in (("f32 flattened", torch.float32, False),
                                  ("f32 per-slot", torch.float32, True),
                                  ("f64 flattened", torch.float64, False),
                                  ("f64 per-slot", torch.float64, True)):
        outs = {}
        for t in (4, 20, 64):
            qt = rnd(t, HK, GQ, DH)
            qt[0] = target
            slot = torch.tensor([0] + [i % 3 + 1 for i in range(t - 1)], device=dev)
            pos = torch.tensor([POS] + [10 + 3 * i for i in range(t - 1)], device=dev)
            outs[f"flat T={t}"] = flat(qt, ck, cv, slot, pos, dtype, per_slot)[0]
        for b, s, row in ((4, 16, 0), (4, 16, 9), (4, 1, 0)):
            q = rnd(b, s, HK, GQ, DH)
            q[0, row] = target
            pos = torch.arange(s, device=dev)[None].repeat(b, 1) + 40
            pos[0] = torch.arange(s, device=dev) + (POS - row)
            valid = torch.arange(VTOK, device=dev)[None, None] <= pos[:, :, None]
            outs[f"chunked {b}x{s} row {row}"] = core(q, ck, cv, valid, dtype)[0, row]
        for s in (77, 128):
            q = rnd(1, s, HK, GQ, DH)
            q[0, POS] = target
            qpos = torch.arange(s, device=dev)
            if per_slot:      # the prompt's rows written into its slot's view
                valid = (torch.arange(VTOK, device=dev)[None] <= qpos[:, None])[None]
                out = core(q, ck[:1], cv[:1], valid, dtype)
            else:             # over the prompt's own keys
                valid = (qpos[None] <= qpos[:, None])[None]
                out = core(q, ck[:1, :s], cv[:1, :s], valid, dtype)
            outs[f"whole {s}"] = out[0, POS]
        ref = outs["flat T=4"]
        same = all(torch.equal(o, ref) for o in outs.values())
        worst = max(float((o - ref).abs().max()) for o in outs.values())
        differ = [k for k, o in outs.items() if not torch.equal(o, ref)]
        print(f"{name}: every layout equal: {same}; max |diff| {worst:.3e}; "
              f"differ: {differ}", flush=True)

    x = rnd(128, 2560)

    def norm(rows, dtype):
        var = torch.mean(torch.square(rows.to(dtype)), dim=-1, keepdim=True)
        return rows * torch.rsqrt(var.to(torch.float32) + 1e-6)

    for dtype in (torch.float32, torch.float64):
        alone = torch.cat([norm(x[i:i + 1], dtype) for i in range(128)])
        differ = {}
        for shape in ((4, 2560), (1, 20, 2560), (4, 16, 2560), (1, 77, 2560),
                      (1, 128, 2560), (4, 1, 2560)):
            n = math.prod(shape[:-1])
            got = norm(x[:n].reshape(shape), dtype).reshape(n, 2560)
            differ[shape] = int((got != alone[:n]).any(dim=-1).sum())
        print(f"rmsnorm, mean square in {dtype}: rows differing from the row alone, per "
              f"call shape: {differ}", flush=True)

    def ms_per_call(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(100):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 100

    qt = rnd(4, HK, GQ, DH)
    slot = torch.arange(4, device=dev)
    pos = torch.tensor([76, 100, 30, 200], device=dev)
    for name, dtype, per_slot in (("f32 flattened", torch.float32, False),
                                  ("f64 flattened", torch.float64, False),
                                  ("f32 per-slot", torch.float32, True),
                                  ("f64 per-slot", torch.float64, True)):
        ms = ms_per_call(lambda: flat(qt, ck, cv, slot, pos, dtype, per_slot))
        print(f"flat decode core, 4 tokens, {name}: {ms:.4f} ms per layer (eager, "
              "host launch included)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
