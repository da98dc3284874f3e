"""Where the port's logits leave the reference's (CPU diagnostics, not a
test).

    PYTHONPATH=src python tests/_torch_divergence.py

Prints, for the reduced configs on the reference's frozen planes:

1. the ``hybrid_whole`` engine scenario's 32-token prompt (request 3 of
   ``test_torch_families.SCENARIOS``): both packages' whole-prefill top-2
   logits and how far the two logit rows are apart;
2. ``hymba-1.5b``'s layer 0 on that prompt: each sub-op of the block on the
   same input in both packages (rmsnorm, attention, the SSM branch) and the
   whole block;
3. the same block run whole in each package, every per-token int8
   activation quantization recorded in call order: how far each input
   differs and which codes moved (the first moved code is the one the
   near-tie rule of ``_torch_serving.assert_same_run`` is about);
4. per family, ``forward`` over 64 x 32 numpy-seeded tokens: positions
   whose logit row moved by more than 1e-4 and argmax flips.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_serving import port_params, reference_frozen, requests  # noqa: E402

import repro.core.ternary as jternary  # noqa: E402
import repro_torch.core.ternary as ternary  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model_zoo as jzoo  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.models import layers, model_zoo, ssm, transformer  # noqa: E402
from repro_torch.serving import Request  # noqa: E402


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def hybrid_prompt() -> None:
    cfg, frozen = reference_frozen("hymba-1.5b")
    params = port_params("hymba-1.5b")
    toks = requests(Request, [3, 8, 16, 32, 5], 5, 7)[3].prompt[None].astype(np.int32)
    want, _ = jzoo.prefill(cfg, frozen, {"tokens": jnp.asarray(toks)}, jzoo.init_cache(cfg, 1, 64))
    got, _ = model_zoo.prefill(cfg, params, {"tokens": torch.from_numpy(toks).long()},
                               model_zoo.init_cache(cfg, 1, 64, device="cpu"))
    for name, row in (("reference", np.asarray(want)[0, 0]), ("port", got.numpy()[0, 0])):
        top = np.argsort(row)[::-1][:2]
        print(f"hymba 32-token prefill, {name}: top-2 {top.tolist()} {row[top].tolist()} "
              f"(margin {row[top[0]] - row[top[1]]:.4g})")
    print(f"  logit rows max abs diff {_diff(want[0, 0], got[0, 0]):.4g}")

    x = np.asarray(jt._embed_inputs(cfg, frozen, {"tokens": jnp.asarray(toks)}, False))
    pos = np.arange(x.shape[1])
    pj = jax.tree.map(lambda v: v[0], frozen["blocks"])
    pp = transformer.layer_slice(params["blocks"], 0)
    hj = jlayers.rmsnorm(pj["ln1"], jnp.asarray(x), cfg.norm_eps)
    ht = torch.from_numpy(np.array(hj))
    same = {
        "rmsnorm": _diff(hj, layers.rmsnorm(pp["ln1"], torch.from_numpy(x), cfg.norm_eps)),
        "attention": _diff(
            jlayers.attention(cfg, pj["attn"], hj, pos=jnp.asarray(pos), is_global=False,
                              train=False)[0],
            layers.attention(cfg, pp["attn"], ht, pos=torch.from_numpy(pos), is_global=False)[0]),
        "ssm": _diff(jssm.ssm_forward(cfg, pj["ssm"], hj, False)[0],
                     ssm.ssm_forward(cfg, pp["ssm"], ht)[0]),
        "block": _diff(
            jt._block(cfg, pj, jnp.asarray(x), flag=False, pos=jnp.asarray(pos), train=False,
                      mode="fwd")[0],
            transformer._block(cfg, pp, torch.from_numpy(x), flag=False,
                               pos=torch.from_numpy(pos), mode="fwd")[0]),
    }
    print("hymba layer 0, each sub-op on the same input, max abs diff: "
          + ", ".join(f"{k} {v:.3g}" for k, v in same.items()))


def moved_codes() -> None:
    cfg, frozen = reference_frozen("hymba-1.5b")
    params = port_params("hymba-1.5b")
    toks = requests(Request, [3, 8, 16, 32, 5], 5, 7)[3].prompt[None].astype(np.int32)
    x = np.asarray(jt._embed_inputs(cfg, frozen, {"tokens": jnp.asarray(toks)}, False))
    pos = np.arange(x.shape[1])
    seen = {"reference": [], "port": []}
    inner = {"reference": jternary.quantize_activations, "port": ternary.quantize_activations}

    def recording(side):
        def quantize(a, eps=1e-6):
            q, s = inner[side](a, eps)
            seen[side].append(tuple(np.asarray(v).reshape(-1, np.shape(v)[-1])
                                    for v in (a, q, s)))
            return q, s
        return quantize

    jternary.quantize_activations = recording("reference")
    ternary.quantize_activations = recording("port")
    try:
        jt._block(cfg, jax.tree.map(lambda v: v[0], frozen["blocks"]), jnp.asarray(x),
                  flag=False, pos=jnp.asarray(pos), train=False, mode="fwd")
        transformer._block(cfg, transformer.layer_slice(params["blocks"], 0),
                           torch.from_numpy(x), flag=False, pos=torch.from_numpy(pos),
                           mode="fwd")
    finally:
        jternary.quantize_activations = inner["reference"]
        ternary.quantize_activations = inner["port"]
    print("hymba layer 0 run whole, each activation quantization in call order:")
    for i, ((aj, qj, sj), (at, qt, st)) in enumerate(zip(seen["reference"], seen["port"])):
        moved = np.argwhere(qj != qt)
        line = (f"  call {i} K={aj.shape[-1]}: inputs differ by {_diff(aj, at):.3g}, "
                f"{len(moved)} codes moved")
        if len(moved):
            r, c = moved[0]
            line += (f"; first at row {r}: a/scale {aj[r, c] / sj[r, 0]:.8g} (reference) "
                     f"against {at[r, c] / st[r, 0]:.8g} (port)")
        print(line)


def family_rates() -> None:
    for arch in ("bitnet-2b-4t", "gemma2-2b", "deepseek-moe-16b", "mamba2-780m", "hymba-1.5b"):
        cfg, frozen = reference_frozen(arch)
        toks = np.random.default_rng(123).integers(0, 100, size=(64, 32)).astype(np.int32)
        want = np.asarray(jax.jit(lambda p, t: jzoo.forward(cfg, p, {"tokens": t},
                                                            train=False)[0])(frozen, toks))
        got = model_zoo.forward(cfg, port_params(arch), {"tokens": torch.from_numpy(toks).long()})[0]
        got = got.numpy()
        moved = int((np.abs(want - got).max(-1) > 1e-4).sum())
        flips = int((want.argmax(-1) != got.argmax(-1)).sum())
        print(f"{arch}: forward over {toks.size} positions: {moved} moved by > 1e-4 "
              f"(max {_diff(want, got):.3g}), {flips} argmax flips")


if __name__ == "__main__":
    hybrid_prompt()
    moved_codes()
    family_rates()
