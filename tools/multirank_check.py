#!/usr/bin/env python3
"""The port across processes on gloo ranks on the CPU, under whatever torch
the machine has, with no JAX: the rank functions of
``tests/_torch_dist.py`` held as ``tests/test_torch_distributed.py`` and
``tests/test_torch_sharded_serving.py`` hold them wherever the check needs
no reference.

    python3 tools/multirank_check.py          # ~1-4 min of CPU

* the serving cells (``launch.dryrun.mesh_cells``) on a (2, 2) mesh:
  reduced bitnet-2b-4t logits equal to the unsharded cells', reduced
  deepseek-moe-16b within 2^-8 through the expert-parallel branch, greedy
  tokens equal; split-KV decode (one KV head: the cache split on its
  sequence, each rank attending over its block) logits equal to the
  unsharded cells' through ``attend_split`` in every decode layer; reduced
  qwen3-32b on (1, 4) (4 query heads split, 2 KV heads not) logits equal,
  one query head per attention core on every rank;
* ``jit_train_step`` on (2, 2), fsdp on and off: the loss within 1e-4 of
  the one-process step, gradients within 1e-3 relative L2 (MoE 1e-2), the
  state back in its placements, whole params alive at once at most the
  params outside the layer stack plus one layer's, gradients
  shard-sized; the MoE step's experts never all-gathered over 'model',
  two token all-to-alls per MoE layer forward, each rank's expert-gradient
  shard within 1e-2 of its slice of the one-process gradient;
* a checkpoint saved from 4 ranks restored onto 2;
* ``psum_compressed`` on 2 and 4 ranks (every rank the same mean, near the
  float mean) and two compressed data-parallel steps on 2 ranks;
* the dry-run per device (``launch.dryrun`` on a fake world of 4 ranks,
  ``launch.mesh.fake_world``): on (2, 2) its FLOPs, kernel tally and
  collective bytes of each kind for reduced bitnet-2b-4t decode and
  prefill, deepseek-moe-16b decode, the train cell with fsdp on and off,
  deepseek-moe-16b's fsdp train cell (all-to-all dispatch) and a split-KV
  decode equal the same counter around rank 0 of 4 gloo ranks running the
  same step, and the fake world's rank 3 the real rank 3's; on the H100's
  device type the FLOPs and tally are the same.

Prints one PASS/FAIL line per check and ``ALL_OK`` at the end; exits 1 if
any check failed.
"""
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]
import _torch_dist as td  # noqa: E402


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main():
    print("python", sys.version.split()[0], "torch", torch.__version__, flush=True)
    work = tempfile.mkdtemp(prefix="multirank_")
    ok = True

    def check(cond, msg):
        nonlocal ok
        print(("PASS " if cond else "FAIL ") + msg, flush=True)
        ok &= bool(cond)

    t0 = time.time()
    for arch in ("bitnet-2b-4t", "deepseek-moe-16b"):
        outs = td.run_ranks(td.serving_rank, 4, work, arch, 8, 4, timeout=600)
        for r, res in enumerate(outs):
            toks = [np.argmax(x, -1).tolist() for x in res["mesh"]]
            want = [np.argmax(x, -1).tolist() for x in res["plain"]]
            err = max(float(np.abs(a - b).max()) for a, b in zip(res["mesh"], res["plain"]))
            if arch == "bitnet-2b-4t":
                check(err == 0 and toks == want, f"serving {arch} rank {r}: logits equal "
                      f"(max err {err}), tokens equal")
            else:
                check(err <= 2 ** -8 and toks == want and res["ep_calls"] == 2 * 5,
                      f"serving {arch} rank {r}: max err {err:.3g}, tokens equal "
                      f"{toks == want}, EP calls {res['ep_calls']}")
    cfg1 = td.reduced("bitnet-2b-4t", n_kv_heads=1)
    outs = td.run_ranks(td.serving_rank, 4, work, "bitnet-2b-4t", 4, 5, {"n_kv_heads": 1},
                        timeout=600)
    for r, res in enumerate(outs):
        err = max(float(np.abs(a - b).max()) for a, b in zip(res["mesh"], res["plain"]))
        check(err == 0 and res["split_kv_calls"] == cfg1.n_layers * 5,
              f"split-KV decode rank {r}: logits equal (max err {err}), attend_split calls "
              f"{res['split_kv_calls']}")
    outs = td.run_ranks(td.serving_rank, 4, work, "qwen3-32b", 8, 4, None, (1, 4),
                        timeout=600)
    for r, res in enumerate(outs):
        toks = [np.argmax(x, -1).tolist() for x in res["mesh"]]
        want = [np.argmax(x, -1).tolist() for x in res["plain"]]
        err = max(float(np.abs(a - b).max()) for a, b in zip(res["mesh"], res["plain"]))
        check(err == 0 and toks == want and set(res["core_heads"]) == {1},
              f"serving qwen3-32b on (1, 4) rank {r}: logits equal (max err {err}), tokens "
              f"equal, query heads per attention core {sorted(set(res['core_heads']))}")
    print(f"serving cells {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    archs = ("bitnet-2b-4t", "deepseek-moe-16b")
    cases = tuple((a, f) for a in archs for f in (False, True))
    params = {a: td.flat(td.port_params(a)) for a in archs}
    batch = {a: td.lm_batch(td.reduced(a), 4, 16, 0) for a in archs}
    ck = os.path.join(work, "ck")
    outs = td.run_ranks(td.jit_step_rank, 4, work, archs, cases, params, batch, ck, timeout=900)
    for arch, fsdp in cases:
        res = outs[0][arch, fsdp]
        same = {o[arch, fsdp]["loss"] for o in outs} == {res["loss"]}
        gtol = 1e-2 if arch == "deepseek-moe-16b" else 1e-3
        worst = max(rel(res["grads"][k], g) for k, g in res["grads_one"].items())
        check(same and abs(res["loss"] - res["loss_one"]) <= 1e-4 and worst <= gtol
              and all(o[arch, fsdp]["same_placements"] for o in outs),
              f"jit_train_step {arch} fsdp={fsdp}: loss {res['loss']:.7f} vs one process "
              f"{res['loss_one']:.7f}, worst grad rel L2 {worst:.2e}")
    n_moe = td.reduced("deepseek-moe-16b").n_layers
    for fsdp in (False, True):
        worst = max(max(o["deepseek-moe-16b", fsdp]["expert_shard_rel"].values()) for o in outs)
        check(all(o["deepseek-moe-16b", fsdp]["expert_gathers_over_model"] == []
                  and o["deepseek-moe-16b", fsdp]["all_to_all"] == 2 * n_moe for o in outs)
              and worst <= 1e-2,
              f"expert-parallel MoE step fsdp={fsdp}: no expert stack gathered over 'model', "
              f"{outs[0]['deepseek-moe-16b', fsdp]['all_to_all']} token all-to-alls, worst "
              f"expert-gradient shard rel L2 {worst:.2e}")
    for o in outs:
        live = o["liveness"]
        check(all(0 < live[m] <= live["top"] + live["layer"] for m in (True, False))
              and live["shard_shapes"], f"fsdp liveness {live}")
    check(all(s["local_shard_differs"] == [] for s in (o["shards"] for o in outs)),
          "placements: DTensor local shards equal local_shard views")
    print(f"jit_train_step {time.time() - t0:.1f} s", flush=True)

    res = td.run_ranks(td.restore_rank, 2, work, ck, timeout=300)
    saved = outs[0]["saved"]
    check(all(np.array_equal(res[0]["params"][k], v) for k, v in saved.items()),
          "checkpoint from 4 ranks restored onto 2")

    for n in (2, 4):
        rng = np.random.default_rng(n)
        grads = {"big": rng.standard_normal((n, 3001)).astype(np.float32),
                 "tiny": rng.standard_normal((n, 7)).astype(np.float32)}
        errs = {k: np.zeros_like(v) for k, v in grads.items()}
        got = td.run_ranks(td.psum_rank, n, work, grads, errs, timeout=300)
        err = float(np.abs(got[0][0]["big"] - grads["big"].mean(0)).max())
        check(all(np.array_equal(g[0]["big"], got[0][0]["big"]) for g in got) and err < 0.05,
              f"psum_compressed on {n} ranks: ranks equal, max |mean err| {err:.3g}")

    arch = "bitnet-2b-4t"
    cfg = td.reduced(arch)
    got = td.run_ranks(td.compressed_dp_rank, 2, work, arch, params[arch],
                       [td.lm_batch(cfg, 4, 16, s) for s in (10, 11)], timeout=300)
    check(got[0]["losses"] == got[1]["losses"] and all(np.isfinite(got[0]["losses"])),
          f"compressed DP step on 2 ranks: losses {got[0]['losses']}")

    t0 = time.time()
    outs = td.run_ranks(td.dryrun_counts_rank, 4, work, td.DRYRUN_CELLS, timeout=600)
    for name in td.DRYRUN_CELLS:
        fake = td.fake_world_counts(name, "cpu")
        real = {k: v for k, v in outs[0][name].items() if k != "ep_calls"}
        check(fake == real and all(o[name]["collectives"] == real["collectives"] for o in outs),
              f"dry-run {name} on (2, 2): fake world = rank 0 of 4 gloo ranks "
              f"({fake['flops']:.0f} FLOPs, tally {fake['kernels']}, collectives "
              f"{fake['collectives']})")
        last = {k: v for k, v in outs[3][name].items() if k != "ep_calls"}
        check(td.fake_world_counts(name, "cpu", rank=3) == last,
              f"dry-run {name} on (2, 2): fake world rank 3 = rank 3 of 4 gloo ranks")
        cuda = td.fake_world_counts(name, "cuda")
        check(cuda["flops"] == fake["flops"] and cuda["kernels"] == fake["kernels"],
              f"dry-run {name} on the H100's device type: collectives {cuda['collectives']}")
    print(f"dry-run per device {time.time() - t0:.1f} s", flush=True)
    print("ALL_OK" if ok else "SOME_FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
