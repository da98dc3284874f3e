"""Helpers of the port's serving tests: reference params (latent and frozen
by the reference) carried across with the bridge, step-plan recording, and
one engine pair (reference and port) run on the same requests."""
import functools

import jax
import numpy as np

import repro.configs as jconfigs
from repro.models import model_zoo as jzoo
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import freeze_params as jfreeze
from repro_torch import bridge
from repro_torch.serving import Request, ServingEngine

COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "total_tokens",
            "peak_kv_blocks", "max_step_tokens", "preemptions", "whole_prefills",
            "rejections")
PREFIX_COUNTERS = ("prefix_hit_rate", "cached_blocks", "prefix_hit_tokens",
                   "prefix_lookups", "prefix_evictions")
SCHED_COUNTERS = ("prefill_tokens_planned", "cached_tokens_skipped", "readmissions")
REGISTRY_COUNTERS = ("planned_tokens", "realized_tokens", "prefill_steps",
                     "decode_steps", "admissions")
FLAT_FIELDS = ("tokens", "slot", "pos", "lengths", "n_real", "emit", "emit_row",
               "width", "view_blocks", "prefill_mask", "prefill_tokens", "decode_tokens")
RECT_FIELDS = ("tokens", "pos", "lengths", "n_real", "emit", "emit_idx", "chunk",
               "view_blocks", "prefill_slot", "prefill_tokens", "decode_tokens")


@functools.lru_cache(maxsize=None)
def reference_latent(arch: str):
    """(reduced config, reference latent params from PRNGKey(0))."""
    cfg = jconfigs.get(arch).reduced()
    return cfg, jzoo.init_params(cfg, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def reference_frozen(arch: str):
    """(reduced config, the reference's frozen params as numpy leaves)."""
    cfg, latent = reference_latent(arch)
    return cfg, jax.tree.map(np.asarray, jfreeze(latent))


def port_params(arch: str) -> dict:
    """The reference's frozen params carried to the CPU (a fresh copy)."""
    return bridge.params_from_reference(reference_frozen(arch)[1], device="cpu")


def requests(cls, lens, max_new: int, seed: int, vocab: int = 100) -> list:
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


def record_plans(engine) -> list:
    """Wrap both planners of ``engine``'s scheduler; returns the list every
    returned plan (or preemption directive) is appended to."""
    plans = []
    for name in ("plan_flat", "plan"):
        inner = getattr(engine.sched, name)

        def wrapped(*args, _inner=inner, **kw):
            plan = _inner(*args, **kw)
            plans.append(plan)
            return plan

        setattr(engine.sched, name, wrapped)
    return plans


def plan_key(plan):
    if plan is None:
        return None
    if not hasattr(plan, "tokens"):
        return ("preempt", plan.slot)
    fields = FLAT_FIELDS if hasattr(plan, "slot") else RECT_FIELDS
    return tuple(np.asarray(getattr(plan, f)).tolist() for f in fields)


def engine_counters(engine) -> dict:
    """Every deterministic counter both engines keep."""
    out = {k: engine.stats[k] for k in COUNTERS + PREFIX_COUNTERS if k in engine.stats}
    out.update({k: getattr(engine.sched, k) for k in SCHED_COUNTERS})
    out.update({k: engine.metrics.get(k).value for k in REGISTRY_COUNTERS})
    return out


def run_pair(arch: str, kw: dict, make_requests, cfg=None):
    """Serve ``make_requests(cls)`` through the reference engine
    (``packed=True``) and the port's (its frozen params carried across, on
    the CPU) with the same options; ``cfg`` replaces the reduced config
    (same params, e.g. another ``capacity_factor``).  Returns (ref, port,
    ref_requests, port_requests, ref_plans, port_plans)."""
    ref_cfg, latent = reference_latent(arch)
    cfg = cfg or ref_cfg
    ref = JServingEngine(cfg, latent, packed=True, **kw)
    # The reference step spells every projection as the planes decode ->
    # int8 dot only when the plan is tsar_mxu and no pools exist.
    kernels = {lp.kernel for by_n in ref.plan.layers.values() for lp in by_n.values()}
    assert kernels == {"tsar_mxu"}, kernels
    leaves = [getattr(k, "key", "") for path, _ in
              jax.tree_util.tree_flatten_with_path(ref.params)[0] for k in path]
    assert not any(str(name).startswith("sp_") for name in leaves)
    port = ServingEngine(cfg, bridge.params_from_reference(
        jax.tree.map(np.asarray, ref.params), device="cpu"), device="cpu", **kw)
    ref_plans, port_plans = record_plans(ref), record_plans(port)
    ref_reqs = ref.run(make_requests(JRequest))
    port_reqs = port.run(make_requests(Request))
    return ref, port, ref_reqs, port_reqs, ref_plans, port_plans


def assert_same_run(ref, port, ref_reqs, port_reqs, ref_plans, port_plans) -> None:
    """Equal plans, greedy tokens and counters; the port's pool drained."""
    assert [plan_key(p) for p in port_plans] == [plan_key(p) for p in ref_plans]
    assert all(r.done for r in port_reqs)
    assert [r.out_tokens for r in port_reqs] == [r.out_tokens for r in ref_reqs]
    assert engine_counters(port) == engine_counters(ref)
    if port.prefix is not None:
        port.prefix.check()
        assert port.kv.blocks_in_use == port.prefix.cached_blocks
    else:
        port.kv.check()
        assert port.kv.blocks_in_use == 0
