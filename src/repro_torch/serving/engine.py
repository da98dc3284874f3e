"""Serving engine: token-packed continuous batching over a block-paged KV
cache (port of ``repro/serving/engine.py``).

Policies (all three run the same per-slot-position decode math, so their
greedy tokens agree):

* ``flat`` (the default): every step is one flat ``(T,)`` model call; the
  scheduler packs one decode token per running request plus fair-shared
  prefill chunks from several prompts, budgeted purely in tokens
  (``token_budget``), and the step runs gather -> ``flat_step`` -> scatter
  -> sampling;
* ``chunked``: the rectangular ``(B, C)`` predecessor, one prefill chunk
  per step beside every decode token (``chunk_step``);
* ``whole``: each admitted prompt is prefilled in one per-slot call
  (``prefill``), then the slots decode in rectangular steps.

``prefix_cache=True`` (or a block cap) forks the cached full blocks of an
admitted prompt instead of recomputing them (``serving.prefix_cache``; the
``flat`` and ``chunked`` policies only).  Weights are frozen to 2-bit
T-SAR planes (``packed=True``), with padded block-sparse pools where a
layer stack's blocks die (``sparse="auto"``); an execution plan compiled
once at init (or supplied) picks each projection's kernel, and every model
call runs inside it: planned ``tsar_sparse_padded`` on a layer with pools
runs the hand-written sparse kernel, the rest the ``tsar_matmul`` kernel.
With ``packed=False`` the latent weights are served as they are (QAT
serving: every projection runs the exact int8 pipeline of
``core.bitlinear.apply_eval``, no kernel): no freeze, no pools, no plan;
a supplied plan warns and is never consulted.  The reference engine's
default is ``packed=False``; the port's is ``packed=True``, its main path.

Every family is served: dense and MoE under any policy; SSM, hybrid,
enc-dec and VLM under ``whole`` only, as in the reference.  An enc-dec
prefill encodes zero ``frames`` and a VLM prefill projects zero
``patches``, the reference's stubs (a VLM slot's cache also holds the
``frontend_seq`` patch positions before its prompt).

Observability, as in the reference: ``tracer=`` records the run
(``obs.trace.EventTracer``; ``flight_recorder=True`` or a capacity attaches
a ring-buffered one), ``incidents=`` attaches an
``obs.incident.IncidentMonitor``, and ``profiler_annotations=True`` wraps
each step's model call in ``obs.trace.step_annotation`` and turns on the
``obs.trace.span`` ranges inside the step for ``torch.profiler``.  None of
them changes a token or a counter.  Two counters are always kept, one
``time.perf_counter`` each a step: ``step_enqueue_s`` (the model calls'
starts to the starts of their synchronizes) and ``step_host_s`` (wall time
in ``step()`` outside the model calls and their synchronizes).
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import bitlinear, ternary
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models import layers, model_zoo
from repro_torch.obs import NULL_TRACER, MetricsRegistry, StatsView
from repro_torch.obs import trace as obs_trace
from repro_torch.plan import BatchProfile, ModelPlan, compile_plan
from repro_torch.plan import runtime as plan_runtime
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import ChunkedScheduler, Preempt, SlotState
from repro_torch.sparse import format as sparse_format
from repro_torch.sparse import stats as sparse_stats


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: list = field(default_factory=list)
    done: bool = False
    # -- latency stats (stamped by the engine) --
    t_submit: float | None = None
    t_admit: float | None = None  # first admission into a slot
    t_first: float | None = None
    t_done: float | None = None
    n_preempted: int = 0          # recompute-preemptions suffered

    @property
    def ttft(self) -> float | None:
        """Time to first token (s)."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit

    @property
    def queue_s(self) -> float | None:
        """Submit -> first admission into a slot (s)."""
        if self.t_submit is None or self.t_admit is None:
            return None
        return self.t_admit - self.t_submit

    @property
    def tpot(self) -> float | None:
        """Mean time per output token after the first (s/token)."""
        if self.t_first is None or self.t_done is None or len(self.out_tokens) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.out_tokens) - 1)


def _stack_slices(w: torch.Tensor) -> list[torch.Tensor]:
    """The 2-D (K, M) slices of a (possibly stacked) weight, in order."""
    return list(w.reshape((-1,) + tuple(w.shape[-2:])))


def _measure_stack(w: torch.Tensor, block_shape: tuple) -> tuple[int, int, float]:
    """Occupancy of one (possibly stacked) latent weight, on its device:
    (stack-wide max live blocks, stack-wide max live blocks in a strip,
    mean live-block fraction over the slices).  It ternarizes each slice
    (``pack_linear`` ternarizes again: a freeze-time double cost the
    reference accepts too)."""
    bk, bm = block_shape
    max_live = s_steps = 0
    bds = []
    for w2 in _stack_slices(w):
        live = sparse_stats.block_occupancy(ternary.absmean_ternarize(w2)[0], bk, bm) > 0
        max_live = max(max_live, int(live.sum()))
        s_steps = max(s_steps, int(live.sum(dim=0).max()))
        bds.append(int(live.sum()) / live.numel())
    return max_live, s_steps, float(np.mean(bds)) if bds else 1.0


def _sparse_prepass(w: torch.Tensor, block_shape: tuple, max_live: int | None = None,
                    s_steps: int | None = None) -> dict | None:
    """Sizing pass for ``sparse="auto"``: the ``pack_linear`` kwargs that
    emit a padded pool sized to the stack-wide maxima, when the mean
    live-block fraction over the stack is below
    ``bitlinear.SPARSE_SIDE_CAR_THRESHOLD``; None when the stack is too dense.
    Caller-supplied ``max_live``/``s_steps`` act as floors (uniform ``sp_*``
    shapes across re-freezes for a saved plan)."""
    measured_live, measured_steps, mean_bd = _measure_stack(w, block_shape)
    if mean_bd >= bitlinear.SPARSE_SIDE_CAR_THRESHOLD:
        return None
    return {"sparse": True, "block_shape": block_shape,
            "max_live": max(measured_live, max_live or 0, 1),
            "s_steps": max(measured_steps, s_steps or 0, 1)}


def freeze_params(params, *, sparse: str | bool = "auto",
                  block_shape: tuple | None = None, max_live: int | None = None,
                  s_steps: int | None = None) -> dict:
    """Pack every BitLinear latent weight ``{'w'}`` to 2-bit planes.

    Stacked (per-layer) weights are packed one ``L`` slice at a time, which
    bounds the transient memory to one layer; dense fp leaves and already
    frozen dicts pass through.

    ``sparse`` controls the padded-pool leaves (``sp_*``,
    ``sparse.format.PaddedBlockSparseTernary``), stacked with one shape
    across the ``L`` axis:

    * ``"auto"`` (default): a pre-pass measures each stack's block occupancy
      and emits pools only where the mean live-block fraction is below
      ``bitlinear.SPARSE_SIDE_CAR_THRESHOLD``, sized to the measured stack-wide
      ``max_live``/``s_steps`` (caller values act as floors); on the meta
      device nothing is measurable, so no pools are emitted (the
      reference's behaviour under tracing);
    * ``True``: always emit pools, padded to ``max_live``/``s_steps`` (the
      full grid and K/bk when None); bounds that do not hold raise;
    * ``False``: planes only.
    """
    if sparse not in (True, False, "auto"):
        raise ValueError(f"freeze_params: sparse={sparse!r} must be True, False, "
                         "or 'auto'")
    bshape = tuple(block_shape or sparse_format.DEFAULT_BLOCK_SHAPE)

    def freeze_leafdict(w: torch.Tensor) -> dict:
        kw = {}
        if sparse is True:
            kw = {"sparse": True, "block_shape": bshape, "max_live": max_live,
                  "s_steps": s_steps}
        elif sparse == "auto" and w.device.type != "meta":
            kw = _sparse_prepass(w, bshape, max_live=max_live, s_steps=s_steps) or {}
        lead = tuple(w.shape[:-2])
        if w.device.type == "meta":
            # Every slice packs to the same shapes: pack one, stack empties.
            one = layers.pack_linear({"w": w.reshape((-1,) + tuple(w.shape[-2:]))[0]}, **kw)
            return {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype, device=w.device)
                    for k, v in one.items()}
        slices = [layers.pack_linear({"w": w2}, **kw) for w2 in _stack_slices(w)]
        return {k: torch.stack([s[k] for s in slices]).reshape(
                    lead + tuple(slices[0][k].shape)) for k in slices[0]}

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"w"}:
                return freeze_leafdict(node["w"])
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def density_telemetry(params) -> dict | None:
    """Per-layer weight-density profile of a packed params tree:
    ``sparse.stats.summarize`` plus the full profile, or None when the tree
    has no BitLinear leaves."""
    profile = sparse_stats.profile_params(params)
    if not profile:
        return None
    out = sparse_stats.summarize(profile)
    out["profile"] = profile
    return out


def packed_fraction(params) -> float:
    """Diagnostic: fraction of param bytes in 2-bit packed form (each plane
    byte counted as the 8 weights it stands for)."""
    packed = total = 0

    def walk(node, names):
        nonlocal packed, total
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, names + (k,))
            return
        nb = node.numel() * node.element_size()
        total += nb
        if any(n in ("sign", "zero") for n in names):
            packed += nb * 8

    walk(params, ())
    return packed / max(total, 1)


# ---------------------------------------------------------------------------
# Step bodies: gather -> model -> scatter (the pools are updated in place)
# ---------------------------------------------------------------------------

def _chunk_call(cfg, params, pools, table, writers, tokens, pos, lengths, emit_idx):
    view = model_zoo.gather_cache_view(pools, table)
    logits, view = model_zoo.chunk_step(cfg, params, tokens, pos, view, lengths)
    pools = model_zoo.scatter_cache_view(pools, writers, view)
    sel = logits[torch.arange(logits.shape[0], device=logits.device), emit_idx]
    return sel, pools


def _flat_call(cfg, params, pools, table, writers, tokens, slot, pos, emit_row):
    with obs_trace.span("kv.gather"):
        view = model_zoo.gather_cache_view(pools, table)
    sel, view = model_zoo.flat_step(cfg, params, tokens, slot, pos, view, emit_row)
    with obs_trace.span("kv.scatter"):
        pools = model_zoo.scatter_cache_view(pools, writers, view)
    return sel, pools


def _whole_prefill_call(cfg, params, pools, table, writers, batch, slot: int):
    view = model_zoo.gather_cache_view(pools, table)
    slot_view = {name: leaf[:, slot:slot + 1] for name, leaf in view.items()}
    logits, slot_view = model_zoo.prefill(cfg, params, batch, slot_view)
    for name, leaf in view.items():
        leaf[:, slot] = slot_view[name][:, 0]
    pools = model_zoo.scatter_cache_view(pools, writers, view)
    return logits[:, -1, :], pools


_CHUNKABLE_FAMILIES = ("dense", "moe")
_POLICIES = ("flat", "chunked", "whole")


class ServingEngine:
    def __init__(self, cfg, params, *, max_len: int = 512, batch_slots: int = 4,
                 packed: bool = True, cache_dtype=torch.float32, seed: int = 0,
                 prefill_chunk: int = 16, block_size: int = 16,
                 kv_blocks: int | None = None, policy: str | None = None,
                 token_budget: int | None = None, profile_density: bool = True,
                 plan: ModelPlan | None = None, sparse: str | bool = "auto",
                 sparse_block: tuple | None = None,
                 prefix_cache: bool | int = False, tracer=None,
                 profiler_annotations: bool = False, incidents=None,
                 flight_recorder: bool | int = False, device="cuda"):
        if policy is None:
            policy = "flat" if cfg.family in _CHUNKABLE_FAMILIES else "whole"
        elif policy not in _POLICIES:
            raise ValueError(f"policy={policy!r} must be one of {_POLICIES} or None")
        elif policy in ("flat", "chunked") and cfg.family not in _CHUNKABLE_FAMILIES:
            # Refused rather than silently downgraded, so that a label names
            # the policy that ran.
            raise ValueError(
                f"policy={policy!r} is unsupported for family {cfg.family!r}; "
                "pass policy=None (auto) or 'whole'")
        self.policy = policy
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = (freeze_params(params, sparse=sparse, block_shape=sparse_block)
                       if packed else params)
        self.max_len = max_len
        self.slots = batch_slots
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.prefill_chunk = prefill_chunk
        # The static per-step token budget T: by default the rectangular
        # bound (prefill_chunk + slots), the TTFT-vs-TPOT knob.
        if token_budget is None:
            token_budget = prefill_chunk + batch_slots
        if token_budget < batch_slots + 1:
            raise ValueError(
                f"token_budget={token_budget} < batch_slots + 1 "
                f"({batch_slots + 1}): every decode slot needs a row plus "
                "at least one prefill token")
        self.token_budget = token_budget
        # Cache positions a VLM slot holds before its prompt (the patches).
        self._extra = cfg.frontend_seq if cfg.family == "vlm" else 0

        self.kv = PagedKVCache(cfg, batch_slots, max_len, block_size=block_size,
                               num_blocks=kv_blocks, dtype=cache_dtype,
                               device=self.device)
        self.sched = ChunkedScheduler(prefill_chunk=prefill_chunk)
        # Prefix-caching KV reuse: True turns it on, an int also caps the
        # cached blocks (LRU-evicted above it).  A hit needs a prefill that
        # can start at the fork boundary, so the ``whole`` policy keeps the
        # cache off (its keys stay in ``stats``, at zero).
        self.prefix: PrefixCache | None = None
        if prefix_cache and self.policy in ("flat", "chunked"):
            cap = (prefix_cache if isinstance(prefix_cache, int)
                   and not isinstance(prefix_cache, bool) else None)
            self.prefix = PrefixCache(self.kv, capacity_blocks=cap)
        self._queue: list[Request] = []
        self._slots: list[SlotState | None] = [None] * batch_slots

        # -- observability ------------------------------------------------------
        # The typed registry owns all run telemetry; ``stats`` is a
        # write-through view over it under the reference's key names.  Every
        # tracer emit site guards on ``tracer.enabled``.
        if tracer is None and flight_recorder:
            # Always-on flight recorder: a ring-buffered tracer cheap enough
            # to leave on, so incident snapshots can dump the last N events.
            # An int picks the ring capacity.
            cap = (flight_recorder if isinstance(flight_recorder, int)
                   and not isinstance(flight_recorder, bool)
                   else obs_trace.DEFAULT_RING_CAPACITY)
            tracer = obs_trace.EventTracer(sink=obs_trace.RingSink(cap))
        self.tracer = NULL_TRACER if tracer is None else tracer
        # Each model call inside a ``torch.profiler`` range named by
        # ``obs.trace.step_annotation``, the step's ``obs.trace.span``s on.
        self._profile_steps = bool(profiler_annotations)
        self._phase: dict[int, str] = {}
        self.sched.tracer = self.tracer
        self.kv.tracer = self.tracer
        if self.prefix is not None:
            self.prefix.tracer = self.tracer
        reg = self.metrics = MetricsRegistry()
        # Incident snapshots: the monitor's hooks sit outside the
        # ``tracer.enabled`` guards and it owns no registry metric, so
        # attaching one changes neither the tokens nor the counters.
        self.incidents = incidents
        self._evictions_seen = 0
        if incidents is not None:
            incidents.bind(registry=reg, tracer=self.tracer)
        self.kv.incidents = incidents
        t_step = reg.counter("step_time_s", "wall seconds in engine step calls, by phase",
                             labels=("phase",))
        self._t_prefill = t_step.labels(phase="prefill")
        self._t_decode = t_step.labels(phase="decode")
        self._c_steps = reg.counter("steps", "engine steps")
        self._c_enqueue = reg.counter(
            "step_enqueue_s", "wall seconds from model calls' starts to their synchronizes")
        self._c_host = reg.counter(
            "step_host_s", "wall seconds in engine steps outside model calls and synchronizes")
        self._c_decode_tokens = reg.counter(
            "decode_tokens", "tokens emitted by pure-decode steps")
        self._c_total_tokens = reg.counter("total_tokens", "all emitted tokens")
        self._c_prefill_tokens = reg.counter(
            "prefill_tokens", "prompt tokens scheduled into chunks")
        self._c_whole_prefills = reg.counter(
            "whole_prefills", "single-call whole-prompt prefills")
        self._c_preemptions = reg.counter(
            "preemptions", "recompute-style slot preemptions")
        self._c_admissions = reg.counter(
            "admissions", "slot admissions (including re-admissions)")
        self._c_rejections = reg.counter(
            "rejections", "requests rejected at admission (prompt can never fit)")
        self._c_planned = reg.counter(
            "planned_tokens", "step-width rows the step multiplies (T)")
        self._c_realized = reg.counter(
            "realized_tokens", "real (non-padding) tokens across steps")
        self._c_prefill_steps = reg.counter(
            "prefill_steps", "steps carrying a prefill chunk")
        self._c_decode_steps = reg.counter("decode_steps", "pure-decode steps")
        self._g_kv = reg.gauge("kv_blocks", "pool blocks in use (peak -> peak_kv_blocks)")
        self._g_step_tokens = reg.gauge(
            "step_tokens", "real tokens of the last step (peak -> max_step_tokens)")
        self._h_ttft = reg.histogram("ttft_s", "time to first token (s)")
        self._h_tpot = reg.histogram(
            "tpot_s", "mean time per output token after the first (s)")
        self._h_queue = reg.histogram("queue_s", "submit -> first slot admission (s)")

        def _cv(m):
            return (lambda: m.value, m.set)

        def _peak(g):
            def setter(v):
                g.value = v
                g.peak = v
            return (lambda: g.peak, setter)

        self.stats = StatsView({
            "prefill_s": _cv(self._t_prefill),
            "decode_s": _cv(self._t_decode),
            "decode_tokens": _cv(self._c_decode_tokens),
            "total_tokens": _cv(self._c_total_tokens),
            "prefill_tokens": _cv(self._c_prefill_tokens),
            "steps": _cv(self._c_steps),
            "whole_prefills": _cv(self._c_whole_prefills),
            "preemptions": _cv(self._c_preemptions),
            "peak_kv_blocks": _peak(self._g_kv),
            "max_step_tokens": _peak(self._g_step_tokens),
        })
        self.stats.bind("rejections", *_cv(self._c_rejections))
        self.stats.bind("step_enqueue_s", *_cv(self._c_enqueue))
        self.stats.bind("step_host_s", *_cv(self._c_host))
        if prefix_cache:
            # The keys exist whenever the cache was requested (at zero under
            # ``whole``) and never otherwise.
            for key, m in (
                ("prefix_hit_rate", reg.gauge(
                    "prefix_hit_rate", "fraction of admitted prompt tokens served from cache")),
                ("cached_blocks", reg.gauge(
                    "cached_blocks", "blocks held by the prefix-cache tree")),
                ("prefix_hit_tokens", reg.counter(
                    "prefix_hit_tokens", "prompt tokens served from cache")),
                ("prefix_lookups", reg.counter(
                    "prefix_lookups", "prefix-cache forks attempted")),
                ("prefix_evictions", reg.counter(
                    "prefix_evictions", "cached blocks evicted")),
            ):
                self.stats.bind(key, *_cv(m))

        # Density telemetry, measured once at init from the packed planes on
        # their device (profile_density=False skips it).
        self.density = (density_telemetry(self.params)
                        if packed and profile_density else None)
        if self.density is not None:
            self.stats["weight_density_mean"] = self.density["density_mean"]
            self.stats["block_density_mean"] = self.density["block_density_mean"]

        # Execution plan, compiled (or supplied) once here; every model call
        # runs inside plan_runtime.activate(self.plan), and no select_kernel
        # call happens after this constructor returns.
        supplied = plan is not None
        if plan is None and packed:
            plan = compile_plan(self.params, BatchProfile(
                decode_ns=(1, batch_slots),
                prefill_ns=(prefill_chunk, batch_slots * (prefill_chunk + 1),
                            token_budget)))
        self.plan = plan
        if plan is not None:
            self.stats["plan_layers"] = len(plan.layers)
            # Shapes shared by layers with conflicting plans take the default
            # realization (the shape-keyed lookup cannot tell them apart).
            self.stats["plan_shape_conflicts"] = len(plan.shape_conflicts())
        if supplied and not packed:
            warnings.warn(
                "repro_torch.serving.ServingEngine: a ModelPlan was supplied but "
                "packed=False: latent serving never consults the plan",
                UserWarning, stacklevel=2)
        elif supplied:
            # A plan saved for another config resolves nothing and would
            # serve every layer unplanned while telemetry claims otherwise.
            matched, total = plan.coverage(self.params)
            self.stats["plan_matched_layers"] = matched
            if matched < total:
                warnings.warn(
                    f"repro_torch.serving.ServingEngine: supplied plan resolves "
                    f"only {matched}/{total} BitLinear layers of this model; "
                    "unmatched layers run the default realization (was the "
                    "plan compiled for a different config?)",
                    UserWarning, stacklevel=2)

    # -- request management --------------------------------------------------

    def submit(self, req: Request):
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        tr = self.tracer
        if tr.enabled:
            tr.begin(req.uid, "req", prompt_len=len(req.prompt),
                     max_new_tokens=req.max_new_tokens)
            tr.begin(req.uid, "queued")
            self._phase[req.uid] = "queued"
        self._queue.append(req)

    def _admit(self):
        rej0 = self.sched.rejections
        admitted = self.sched.admit(self._slots, self._queue, self.kv,
                                    extra_positions=self._extra,
                                    reserve_full=self.policy == "whole",
                                    prefix_cache=self.prefix)
        if self.sched.rejections > rej0:
            n_rej = self.sched.rejections - rej0
            self._c_rejections.inc(n_rej)
            if self.incidents is not None:
                self.incidents.observe("rejection", n=n_rej, queue_len=len(self._queue))
        tr = self.tracer
        for i, st in admitted:
            self._c_admissions.inc()
            if st.req.t_admit is None:
                st.req.t_admit = time.perf_counter()
                self._h_queue.observe(st.req.queue_s)
            if tr.enabled:
                tr.begin(st.req.uid, "prefill", slot=i, cached_len=st.cached_len)
                self._phase[st.req.uid] = "prefill"
            if self.policy == "whole":
                self._prefill_slot(i, st)
            # flat/chunked: the scheduler interleaves this prompt's chunks
            # with running decodes from the next step on; a prefix-cache hit
            # already forked the cached blocks and moved the cursor past them.

    # -- prefix-cache registration -------------------------------------------

    def _register_prefix(self, i: int, st: SlotState):
        """Register slot ``i``'s cache content with the prefix cache: exactly
        ``req.prompt + out_tokens`` cut to the live length (the last sampled
        token's K/V row is never written).  Only full blocks join the tree,
        so a later write to the slot's partial tail never touches a cached
        block."""
        if self.prefix is None:
            return
        req = st.req
        content = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.out_tokens, np.int32)])
        self.prefix.insert(content[:int(self.kv.lengths[i])], self.kv.table[i])

    def _sync_prefix_stats(self):
        if self.prefix is not None:
            self.stats.update(self.prefix.stats())

    def _planned(self, fn, *args):
        """``fn(*args)`` inside the engine's execution plan."""
        with plan_runtime.activate(self.plan):
            return fn(*args)

    def _sync(self):
        with obs_trace.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def _prefill_slot(self, i: int, st: SlotState):
        """Whole-prompt prefill of one slot through the paged cache.  The
        enc-dec and VLM frontends are the reference's stubs: zero frame or
        patch embeddings."""
        cfg = self.cfg
        batch = {"tokens": self._to_device(st.prompt)[None, :]}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((1, cfg.frontend_seq, cfg.frontend_dim),
                                           dtype=torch.float32, device=self.device)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((1, cfg.enc_seq, cfg.d_model),
                                          dtype=torch.float32, device=self.device)
        tables = self._tables(self.kv.max_blocks)
        t0 = time.perf_counter()
        sel, self.kv.pools = self._planned(_whole_prefill_call, self.cfg, self.params,
                                           self.kv.pools, *tables, batch, i)
        self._c_enqueue.inc(time.perf_counter() - t0)
        self._sync()
        dt = time.perf_counter() - t0
        self._t_prefill.inc(dt)
        self._c_whole_prefills.inc()
        self._g_step_tokens.set(len(st.prompt) + st.extra)
        if self.tracer.enabled:
            self.tracer.mark(st.req.uid, "prefill_chunk", n=len(st.prompt), start=0,
                             whole=True)
        self.kv.lengths[i] = len(st.prompt) + st.extra
        st.cursor = len(st.prompt)
        tok = int(self._sample(sel, np.array([st.req.temperature], np.float32))[0])
        self._emit_token(i, st, tok)

    # -- sampling -------------------------------------------------------------

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> np.ndarray:
        """Per-slot sampling: greedy rows take the argmax, rows with
        ``temperature > 0`` draw from the tempered categorical through the
        engine's seeded generator (its draws differ from the reference's
        JAX PRNG)."""
        greedy = torch.argmax(logits, dim=-1)
        if not (temps > 0).any():
            return greedy.cpu().numpy()
        t = torch.as_tensor(np.where(temps > 0, temps, 1.0), dtype=torch.float32,
                            device=logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        samp = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        hot = torch.as_tensor(temps > 0, device=logits.device)
        return torch.where(hot, samp, greedy).cpu().numpy()

    def _emit_token(self, i: int, st: SlotState, tok: int):
        req = st.req
        req.out_tokens.append(tok)
        tr = self.tracer
        first = req.t_first is None
        if first:
            req.t_first = time.perf_counter()
            self._h_ttft.observe(req.ttft)
            if self.incidents is not None:
                self.incidents.request_first_token(req)
        if tr.enabled:
            if self._phase.get(req.uid) == "prefill":
                tr.end(req.uid, "prefill")
                tr.begin(req.uid, "decode")
                self._phase[req.uid] = "decode"
            if first:
                tr.mark(req.uid, "first_token")
        self._c_total_tokens.inc()
        if (len(req.out_tokens) >= req.max_new_tokens
                or self.kv.lengths[i] >= self.max_len - 1):
            req.done = True
            req.t_done = time.perf_counter()
            self._h_tpot.observe(req.tpot)
            if self.incidents is not None:
                self.incidents.request_finished(req)
            if tr.enabled:
                tr.end(req.uid, "decode")
                tr.mark(req.uid, "finished", n_out=len(req.out_tokens),
                        preemptions=req.n_preempted)
                tr.end(req.uid, "req")
                self._phase.pop(req.uid, None)
            # Register prompt + generated tokens (multi-turn reuse: a
            # follow-up quoting this conversation hits them) while the slot
            # still holds its block references.
            self._register_prefix(i, st)
            self.kv.free_slot(i)
            self._slots[i] = None
        else:
            st.last_tok = tok

    # -- main loop ------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64).to(self.device)

    def _tables(self, view_blocks: int) -> tuple:
        """The step's block table on the device and the scatter's write
        index, both from the host table."""
        tbl = self.kv.host_table(view_blocks)
        return self._to_device(tbl), model_zoo.first_writers(tbl, self.device)

    def step(self) -> bool:
        """One engine step: admit (whole-prefilling admitted prompts under
        ``whole``), then one flat (``flat``) or rectangular (``chunked``,
        ``whole``) prefill/decode call.  Returns False when there was
        nothing to do."""
        if not self._profile_steps:
            return self._step()
        with obs_trace.spans():
            return self._step()

    def _step(self) -> bool:
        t_in = time.perf_counter()
        model0 = self._t_prefill.value + self._t_decode.value
        with obs_trace.span("admit"):
            self._admit()
        flat = self.policy == "flat"

        def _plan():
            if flat:
                return self.sched.plan_flat(self._slots, self.kv, self.token_budget)
            return self.sched.plan(self._slots, self.kv)

        with obs_trace.span("plan"):
            plan = _plan()
            while isinstance(plan, Preempt):
                self._preempt(plan.slot)
                plan = _plan()
        if plan is None:
            return False

        with obs_trace.span("upload"):
            tables = self._tables(plan.view_blocks)
            if flat:
                call, rows = _flat_call, (plan.tokens, plan.slot, plan.pos, plan.emit_row)
            else:
                call, rows = _chunk_call, (plan.tokens, plan.pos, plan.lengths, plan.emit_idx)
            rows = [self._to_device(a) for a in rows]
        step_no = self._c_steps.value
        # planned = the rows the step's matmuls multiply (flat: T;
        # rectangular: the padded B*C); realized/planned is the step-budget
        # utilization.
        planned = plan.width if flat else self.slots * plan.chunk
        ann = (obs_trace.step_annotation(step_no) if self._profile_steps
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ann:
            sel, self.kv.pools = self._planned(call, self.cfg, self.params, self.kv.pools,
                                               *tables, *rows)
            t_sync = time.perf_counter()
            self._sync()
        dt = time.perf_counter() - t0

        self._c_steps.inc()
        self._c_enqueue.inc(t_sync - t0)
        self._c_planned.inc(planned)
        self._c_realized.inc(plan.real_tokens)
        self._g_step_tokens.set(plan.real_tokens)
        self._g_kv.set(int(self.kv.blocks_in_use))
        self._c_prefill_tokens.inc(plan.prefill_tokens)
        if plan.prefill_tokens > 0:
            self._t_prefill.inc(dt)
            self._c_prefill_steps.inc()
        else:
            self._t_decode.inc(dt)
            self._c_decode_steps.inc()
            self._c_decode_tokens.inc(plan.decode_tokens)

        tr = self.tracer
        if tr.enabled:
            tr.step(dt, step=step_no, planned=planned,
                    realized=plan.real_tokens,
                    prefill_tokens=plan.prefill_tokens,
                    decode_tokens=plan.decode_tokens,
                    kv_blocks=int(self.kv.blocks_in_use),
                    active_slots=sum(1 for s in self._slots if s is not None),
                    kernel=(self.plan.dominant_kernel(planned)
                            if self.plan is not None else None))

        toks = None
        if plan.emit.any():
            with obs_trace.span("sample"):
                temps = np.array([
                    self._slots[i].req.temperature if plan.emit[i] else 0.0
                    for i in range(self.slots)], np.float32)
                toks = self._sample(sel, temps)
        with obs_trace.span("emit"):
            for i in range(self.slots):
                st = self._slots[i]
                if st is None or plan.n_real[i] == 0:
                    continue
                self.kv.lengths[i] += int(plan.n_real[i])
                advanced = plan.advances_prefill(i)
                if advanced:
                    if tr.enabled:
                        tr.mark(st.req.uid, "prefill_chunk",
                                n=int(plan.n_real[i]), start=st.cursor)
                    st.cursor += int(plan.n_real[i])
                if plan.emit[i]:
                    self._emit_token(i, st, int(toks[i]))
                if advanced and not st.prefilling and self._slots[i] is not None:
                    # Prompt fully in cache and the request still live: register
                    # its full blocks now, so requests sharing the prefix hit it
                    # while this one decodes.  After the emit: a request that
                    # finished on its first token was registered at finish.
                    self._register_prefix(i, st)
            self._sync_prefix_stats()
            if self.incidents is not None:
                ev = int(self.stats["prefix_evictions"]) if self.prefix is not None else 0
                self.incidents.step_tick(evictions=max(0, ev - self._evictions_seen))
                self._evictions_seen = ev
        # Every model call of the step (whole prefills in ``_admit`` too)
        # added its wall seconds to the phase counters.
        model = self._t_prefill.value + self._t_decode.value - model0
        self._c_host.inc(time.perf_counter() - t_in - model)
        return True

    def _preempt(self, i: int):
        """Recompute-style preemption: return the youngest request to the
        queue head; its prompt + generated tokens re-prefill later.  Its
        full blocks are registered with the prefix cache (when attached)
        before they are released, so the re-admission forks them back and
        re-prefills only the partial tail."""
        st = self._slots[i]
        tr = self.tracer
        if tr.enabled:
            uid = st.req.uid
            ph = self._phase.get(uid)
            if ph in ("prefill", "decode"):
                tr.end(uid, ph, preempted=True)
            tr.mark(uid, "preempted", slot=i, cursor=st.cursor,
                    cached_len=st.cached_len)
            tr.begin(uid, "queued")
            self._phase[uid] = "queued"
        self._register_prefix(i, st)
        self.kv.free_slot(i)
        self._slots[i] = None
        self._queue.insert(0, st.req)
        self._c_preemptions.inc()
        st.req.n_preempted += 1
        if self.incidents is not None:
            self.incidents.observe("preemption", uid=st.req.uid, slot=i, cursor=st.cursor,
                                   n_preempted=st.req.n_preempted)

    @property
    def busy(self) -> bool:
        """True while any request is queued or resident in a slot."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    def run(self, requests: list[Request]) -> list[Request]:
        for r in requests:
            self.submit(r)
        while self.busy:
            if not self.step() and self._queue:
                raise RuntimeError(
                    f"request uid={self._queue[0].uid} cannot be admitted: "
                    f"KV pool ({self.kv.num_blocks - 1} blocks of "
                    f"{self.kv.block_size}) smaller than the admission gate; "
                    "raise kv_blocks or lower prefill_chunk/max_len")
        return requests

    # -- benchmarking hooks ---------------------------------------------------

    def warmup(self, seq_len: int | None = None) -> None:
        """Run a throwaway request over the step paths (prefill width, pure
        decode, the block-table views up to ``seq_len`` positions), then
        :meth:`reset_run_stats`.  On the card the main path's two libraries
        are built first, together, and the first call of each kernel loads
        it, so a replay's percentiles measure serving, not ``nvcc``.  Needs
        an idle engine."""
        if self.busy:
            raise RuntimeError("warmup() requires an idle engine")
        if self.device.type == "cuda":
            # The projections' and the flat attention's libraries: one nvcc
            # each, at once, rather than one after another at their first
            # launches (a checkout's first run builds them).
            _build.build(("tsar_matmul", "flat_attn"))
        total = seq_len or (self.prefill_chunk + 3)
        # Room for the generated tokens, the headroom position and a VLM's
        # patch positions.
        plen = max(2, min(total - 2, self.max_len - self._extra - 3))
        rng = np.random.default_rng(0x7e57)
        prompt = rng.integers(0, self.cfg.vocab_size, size=plen, dtype=np.int32)
        self.run([Request(uid=-1, prompt=prompt, max_new_tokens=2)])
        self.reset_run_stats()

    def reset_run_stats(self) -> None:
        """Zero the per-run counters, drop the prefix-cache tree (a fresh one
        takes its place) and clear trace events, keeping init-time telemetry
        (plan and density keys).  The peak gauges are rebased to the live
        values after the reset, so warm-up never leaks into a run's peaks.
        Needs an idle engine."""
        if self.busy:
            raise RuntimeError("reset_run_stats() requires an idle engine")
        if self.prefix is not None:
            # All slots are free, so every cached block is evictable.
            self.prefix.evict(self.prefix.cached_blocks, cause="reset")
            self.prefix = PrefixCache(self.kv, capacity_blocks=self.prefix.capacity)
            self.prefix.tracer = self.tracer
        self.sched.prefill_tokens_planned = 0
        self.sched.cached_tokens_skipped = 0
        self.sched.readmissions = 0
        self.sched.rejections = 0
        self._g_kv.set(int(self.kv.blocks_in_use))
        self._g_step_tokens.set(0)
        self.metrics.reset_run()
        self._sync_prefix_stats()
        # A streaming sink truncates its on-disk segments here too, so
        # warm-up events never reach a saved trace.
        self.tracer.reset()
        self._evictions_seen = 0
        if self.incidents is not None:
            # Warm-up incidents are noise: their files go and the debouncing
            # re-arms.
            self.incidents.reset_run()

    # -- metrics --------------------------------------------------------------

    def throughput(self) -> float:
        """Steady-state decode tokens/s (pure-decode steps only)."""
        return self.stats["decode_tokens"] / max(self.stats["decode_s"], 1e-9)

    def max_step_tokens(self) -> int:
        return self.stats["max_step_tokens"]

    def latency_stats(self, requests: list[Request]) -> dict:
        """Mean and max TTFT, mean TPOT over finished requests (seconds)."""
        ttfts = [r.ttft for r in requests if r.ttft is not None]
        tpots = [r.tpot for r in requests if r.tpot is not None]

        def mean(xs):
            return sum(xs) / len(xs) if xs else float("nan")

        return {"ttft_mean_s": mean(ttfts), "ttft_max_s": max(ttfts, default=float("nan")),
                "tpot_mean_s": mean(tpots), "n": len(ttfts)}

    def latency_percentiles(self) -> dict:
        """{ttft_s, tpot_s, queue_s} -> {p50, p90, p99, mean, max, n}."""
        return {name: self.metrics.get(name).summary()
                for name in ("ttft_s", "tpot_s", "queue_s")}
