"""Helpers of the port's serving tests: reference params (latent and frozen
by the reference) carried across with the bridge, step-plan recording, one
engine pair (reference and port) run on the same requests, and a workload
trace's replay through the port's engine (:func:`workload_engine`,
:func:`replay`).

The comparison of a pair (:func:`assert_same_run`) holds the port to the
project's float contract: plans, greedy tokens and counters are equal,
except that one request per run may pick another token where the
reference's own logits sit at a near tie (see :func:`near_tie`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import model_zoo as jzoo
from repro_torch.models import model_zoo
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import freeze_params as jfreeze
from repro_torch import bridge
from repro_torch.serving import Request, ServingEngine
from repro_torch.workloads import runner

COUNTERS = ("steps", "prefill_tokens", "decode_tokens", "total_tokens",
            "peak_kv_blocks", "max_step_tokens", "preemptions", "whole_prefills",
            "rejections")
PREFIX_COUNTERS = ("prefix_hit_rate", "cached_blocks", "prefix_hit_tokens",
                   "prefix_lookups", "prefix_evictions")
SCHED_COUNTERS = ("prefill_tokens_planned", "cached_tokens_skipped", "readmissions")
REGISTRY_COUNTERS = ("planned_tokens", "realized_tokens", "prefill_steps",
                     "decode_steps", "admissions")
# The near-tie excuse: the two packages' logit rows at the diverging
# position agree within ROW_GAP (absolute; hymba-1.5b's measured 0.0178),
# and the reference's margin between its pick and the port's is below
# MARGIN_PER_GAP times that gap.
ROW_GAP = 0.05
MARGIN_PER_GAP = 2.0
FLAT_FIELDS = ("tokens", "slot", "pos", "lengths", "n_real", "emit", "emit_row",
               "width", "view_blocks", "prefill_mask", "prefill_tokens", "decode_tokens")
RECT_FIELDS = ("tokens", "pos", "lengths", "n_real", "emit", "emit_idx", "chunk",
               "view_blocks", "prefill_slot", "prefill_tokens", "decode_tokens")


@pytest.fixture(autouse=False)
def one_torch_thread():
    """torch on one intra-op thread for the test: the reduced configs' ops
    are tiny, and with several test workers sharing the cores the thread
    pools of every worker only contend (a restart test took 100 s where it
    takes 1 s alone).  Restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@functools.lru_cache(maxsize=None)
def reference_dense(arch: str):
    """(reduced config, the reference's latent weights as plain dense
    ``{'wd'}`` projections, numpy leaves): no int8 activation codes, so a
    float32 rounding difference between the packages stays a rounding
    difference."""
    cfg, latent = reference_latent(arch)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w"}:
                return {"wd": np.asarray(node["w"])}
            return {k: walk(v) for k, v in node.items()}
        return np.asarray(node)

    return cfg, walk(latent)


def port_params(arch: str) -> dict:
    """The reference's frozen params carried to the CPU (a fresh copy)."""
    return bridge.params_from_reference(reference_frozen(arch)[1], device="cpu")


def workload_engine(spec, cfg, params, *, prefix_cache=None, **kw):
    """The port's engine on the CPU from a workload spec's engine hints
    (``repro_torch.workloads.runner.build_engine``); ``prefix_cache``
    overrides the hint, ``kw`` adds options (``tracer``, ``incidents``,
    ...)."""
    return runner.build_engine(spec, cfg, params, prefix_cache=prefix_cache, device="cpu",
                               **kw)


def replay(engine, trace, step_dt: float = 1.0):
    """The trace replayed through the port's engine in virtual time
    (``repro_torch.workloads.runner.replay``): (requests, wall seconds)."""
    return runner.replay(engine, trace, step_dt=step_dt)


def requests(cls, lens, max_new: int, seed: int, vocab: int = 100) -> list:
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


class PlanLog(list):
    """The plans (or preemption directives) a scheduler returned, in order;
    ``owners[i]`` maps each occupied slot to (request uid, tokens it had
    emitted) when plan ``i`` was made."""

    def __init__(self):
        super().__init__()
        self.owners = []


def record_plans(engine) -> PlanLog:
    """Wrap both planners of ``engine``'s scheduler; returns the
    :class:`PlanLog` every plan is appended to."""
    plans = PlanLog()
    for name in ("plan_flat", "plan"):
        inner = getattr(engine.sched, name)

        def wrapped(slots, *args, _inner=inner, **kw):
            owners = {i: (st.req.uid, len(st.req.out_tokens))
                      for i, st in enumerate(slots) if st is not None}
            plan = _inner(slots, *args, **kw)
            plans.append(plan)
            plans.owners.append(owners)
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


def run_pair(arch: str, kw: dict, make_requests, cfg=None, mutate=None):
    """Serve ``make_requests(cls)`` through the reference engine
    (``packed=True``) and the port's (its frozen params carried across, on
    the CPU) with the same options; ``cfg`` replaces the reduced config
    (same params, e.g. another ``capacity_factor``); ``mutate`` is applied
    to the port's copy of the params before its engine is built.  Returns
    (ref, port, ref_requests, port_requests, ref_plans, port_plans)."""
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
    params = bridge.params_from_reference(jax.tree.map(np.asarray, ref.params), device="cpu")
    if mutate is not None:
        mutate(params)
    port = ServingEngine(cfg, params, device="cpu", **kw)
    ref_plans, port_plans = record_plans(ref), record_plans(port)
    ref_reqs = ref.run(make_requests(JRequest))
    port_reqs = port.run(make_requests(Request))
    return ref, port, ref_reqs, port_reqs, ref_plans, port_plans


def run_latent_pair(arch: str, kw: dict, make_requests):
    """Serve ``make_requests(cls)`` through both engines with
    ``packed=False`` (latent QAT serving) on the reference's latent params
    (carried across, on the CPU).  Returns what :func:`run_pair` returns."""
    cfg, latent = reference_latent(arch)
    ref = JServingEngine(cfg, latent, packed=False, **kw)
    params = bridge.params_from_reference(jax.tree.map(np.asarray, latent), device="cpu")
    port = ServingEngine(cfg, params, device="cpu", packed=False, **kw)
    ref_plans, port_plans = record_plans(ref), record_plans(port)
    ref_reqs = ref.run(make_requests(JRequest))
    port_reqs = port.run(make_requests(Request))
    return ref, port, ref_reqs, port_reqs, ref_plans, port_plans


def _stub_batch(cfg, tokens: np.ndarray) -> dict:
    """A one-row prefill batch as both engines build it: the tokens and the
    enc-dec / VLM frontends' zero stubs (numpy)."""
    batch = {"tokens": tokens[None].astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = np.zeros((1, cfg.frontend_seq, cfg.frontend_dim), np.float32)
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((1, cfg.enc_seq, cfg.d_model), np.float32)
    return batch


def near_tie(ref, port, history: np.ndarray, ref_tok: int, port_tok: int) -> tuple:
    """Both packages' next-token logit rows after ``history`` (a request's
    prompt and the tokens both engines emitted before they differed), each
    through its own ``model_zoo.prefill`` on its engine's params.  Returns
    (the reference's margin between its pick and the port's pick, the max
    absolute difference between the two rows)."""
    cfg = ref.cfg
    batch = _stub_batch(cfg, history)
    extra = cfg.frontend_seq if cfg.family == "vlm" else 0
    want, _ = jzoo.prefill(cfg, ref.params, jax.tree.map(jnp.asarray, batch),
                           jzoo.init_cache(cfg, 1, len(history) + extra))
    got, _ = model_zoo.prefill(cfg, port.params, {
        k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
        for k, v in batch.items()},
        model_zoo.init_cache(cfg, 1, len(history) + extra, device="cpu"))
    want, got = np.asarray(want)[0, -1], got.numpy()[0, -1]
    return float(want[ref_tok] - want[port_tok]), float(np.abs(want - got).max())


def _masked_key(plan, owners: dict, excused: dict):
    """``plan_key`` with the token entries of excused requests' slots
    blanked once the request had emitted its first differing token."""
    key = plan_key(plan)
    if key is None or key[0] == "preempt":
        return key
    tokens = key[0]
    for s, (uid, n_out) in owners.items():
        if uid in excused and n_out > excused[uid]:
            if hasattr(plan, "slot"):                     # flat: (T,) with slot ids
                tokens = [None if sl == s else t for t, sl in zip(tokens, key[1])]
            else:                                         # rectangular: (B, C)
                tokens = [None if i == s else row for i, row in enumerate(tokens)]
    return (tokens,) + key[1:]


def assert_same_run(ref, port, ref_reqs, port_reqs, ref_plans, port_plans) -> None:
    """Equal plans, greedy tokens and counters; the port's pool drained.

    The float contract of the project (ROADMAP: where the reference's
    contract is floating-point, the port matches within its tolerances)
    allows one exception per run.  Where a request's greedy token first
    differs, both packages' logit rows for that position are recomputed
    from the shared history (:func:`near_tie`); the difference is excused
    when the rows agree within ``ROW_GAP`` and the reference's margin
    between its pick and the port's is below ``MARGIN_PER_GAP`` times the
    rows' gap.  From that token on, that request's tokens and its slot's
    token rows in the plans are not compared; every other request's
    tokens, every other plan field, the slot owners and every counter
    stay strict.  More than one excused request fails; an excuse used is
    printed with its margin and gap.
    """
    assert all(r.done for r in port_reqs)
    assert [r.uid for r in port_reqs] == [r.uid for r in ref_reqs]
    excused = {}
    for rr, pr in zip(ref_reqs, port_reqs):
        if pr.out_tokens == rr.out_tokens:
            continue
        assert len(pr.out_tokens) == len(rr.out_tokens), (rr.uid, rr.out_tokens, pr.out_tokens)
        j = next(i for i, (a, b) in enumerate(zip(rr.out_tokens, pr.out_tokens)) if a != b)
        history = np.concatenate([np.asarray(rr.prompt, np.int32),
                                  np.asarray(rr.out_tokens[:j], np.int32)])
        margin, gap = near_tie(ref, port, history, rr.out_tokens[j], pr.out_tokens[j])
        what = (f"request {rr.uid} token {j}: reference picks {rr.out_tokens[j]}, port "
                f"{pr.out_tokens[j]}; reference margin {margin:.6g}, logit rows {gap:.6g} "
                "apart")
        assert gap <= ROW_GAP and margin < MARGIN_PER_GAP * gap, \
            f"{what}: not a near tie (rows within {ROW_GAP}, margin below " \
            f"{MARGIN_PER_GAP} x gap)"
        print(f"assert_same_run: {what}: excused as a near tie")
        excused[rr.uid] = j
    assert len(excused) <= 1, f"more than one request needs the near-tie excuse: {excused}"
    assert len(port_plans) == len(ref_plans)
    assert port_plans.owners == ref_plans.owners
    assert ([_masked_key(p, o, excused) for p, o in zip(port_plans, port_plans.owners)]
            == [_masked_key(p, o, excused) for p, o in zip(ref_plans, ref_plans.owners)])
    assert engine_counters(port) == engine_counters(ref)
    if port.prefix is not None:
        port.prefix.check()
        assert port.kv.blocks_in_use == port.prefix.cached_blocks
    else:
        port.kv.check()
        assert port.kv.blocks_in_use == 0
