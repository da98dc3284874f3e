"""Serving engine: token-packed continuous batching over a block-paged KV
cache (port of ``repro/serving/engine.py``).

Every engine step is one flat ``(T,)`` model call (the ``flat`` policy):
the scheduler packs one decode token per running request plus fair-shared
prefill chunks from several prompts, budgeted purely in tokens
(``token_budget``), and the step runs gather -> ``flat_step`` -> scatter ->
sampling.  Weights are frozen to 2-bit T-SAR planes (``packed=True``), with
padded block-sparse pools where a layer stack's blocks die
(``sparse="auto"``); an execution plan compiled once at init (or supplied)
picks each projection's kernel, and the step runs inside it: planned
``tsar_sparse_padded`` on a layer with pools runs the hand-written sparse
kernel, the rest the ``tsar_matmul`` kernel.

Ported so far: ``policy="flat"`` with packed weights, plans, the sparse
freeze pre-pass, greedy and temperature sampling, and the registry-backed
``stats``.  The prefix cache, the ``chunked``/``whole`` policies and latent
(``packed=False``) serving are later slices.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import bitlinear, ternary
from repro_torch.device import resolve_device
from repro_torch.models import layers, model_zoo
from repro_torch.obs import NULL_TRACER, MetricsRegistry, StatsView
from repro_torch.plan import BatchProfile, ModelPlan, compile_plan
from repro_torch.plan import runtime as plan_runtime
from repro_torch.serving.kv_cache import PagedKVCache
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
      ``max_live``/``s_steps`` (caller values act as floors);
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
        elif sparse == "auto":
            kw = _sparse_prepass(w, bshape, max_live=max_live, s_steps=s_steps) or {}
        slices = [layers.pack_linear({"w": w2}, **kw) for w2 in _stack_slices(w)]
        lead = tuple(w.shape[:-2])
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


def _flat_call(cfg, params, pools, table, tokens, slot, pos, emit_row):
    view = model_zoo.gather_cache_view(pools, table)
    sel, view = model_zoo.flat_step(cfg, params, tokens, slot, pos, view, emit_row)
    pools = model_zoo.scatter_cache_view(pools, table, view)
    return sel, pools


def _later_slice(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"ServingEngine: {what} is not ported yet; it comes with the "
        f"{slice_name} slice of the port")


class ServingEngine:
    def __init__(self, cfg, params, *, max_len: int = 512, batch_slots: int = 4,
                 packed: bool = True, cache_dtype=torch.float32, seed: int = 0,
                 prefill_chunk: int = 16, block_size: int = 16,
                 kv_blocks: int | None = None, policy: str | None = None,
                 token_budget: int | None = None, profile_density: bool = True,
                 plan: ModelPlan | None = None, sparse: str | bool = "auto",
                 sparse_block: tuple | None = None,
                 prefix_cache: bool | int = False, tracer=None, device="cuda"):
        if not packed:
            raise _later_slice("latent (packed=False) serving", "training")
        if prefix_cache:
            raise _later_slice("prefix_cache=", "serving/prefix_cache.py")
        if policy not in (None, "flat"):
            raise _later_slice(f"policy={policy!r}", "remaining attention branches")
        if cfg.family != "dense" or cfg.is_moe:
            raise _later_slice(f"family {cfg.family!r}", "other model families")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = freeze_params(params, sparse=sparse, block_shape=sparse_block)
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

        self.kv = PagedKVCache(cfg, batch_slots, max_len, block_size=block_size,
                               num_blocks=kv_blocks, dtype=cache_dtype,
                               device=self.device)
        self.sched = ChunkedScheduler(prefill_chunk=prefill_chunk)
        self._queue: list[Request] = []
        self._slots: list[SlotState | None] = [None] * batch_slots

        # -- observability ------------------------------------------------------
        # The typed registry owns all run telemetry; ``stats`` is a
        # write-through view over it under the reference's key names.  Every
        # tracer emit site guards on ``tracer.enabled``.
        self.tracer = NULL_TRACER if tracer is None else tracer
        self._phase: dict[int, str] = {}
        self.sched.tracer = self.tracer
        self.kv.tracer = self.tracer
        reg = self.metrics = MetricsRegistry()
        t_step = reg.counter("step_time_s", "wall seconds in engine step calls, by phase",
                             labels=("phase",))
        self._t_prefill = t_step.labels(phase="prefill")
        self._t_decode = t_step.labels(phase="decode")
        self._c_steps = reg.counter("steps", "engine steps")
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

        # Density telemetry, measured once at init from the packed planes on
        # their device (profile_density=False skips it).
        self.density = density_telemetry(self.params) if profile_density else None
        if self.density is not None:
            self.stats["weight_density_mean"] = self.density["density_mean"]
            self.stats["block_density_mean"] = self.density["block_density_mean"]

        # Execution plan, compiled (or supplied) once here; every step runs
        # inside plan_runtime.activate(self.plan), and no select_kernel call
        # happens after this constructor returns.
        supplied = plan is not None
        if plan is None:
            plan = compile_plan(self.params, BatchProfile(
                decode_ns=(1, batch_slots),
                prefill_ns=(prefill_chunk, batch_slots * (prefill_chunk + 1),
                            token_budget)))
        self.plan = plan
        self.stats["plan_layers"] = len(plan.layers)
        # Shapes shared by layers with conflicting plans take the default
        # realization (the shape-keyed lookup cannot tell them apart).
        self.stats["plan_shape_conflicts"] = len(plan.shape_conflicts())
        if supplied:
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
        admitted = self.sched.admit(self._slots, self._queue, self.kv)
        if self.sched.rejections > rej0:
            self._c_rejections.inc(self.sched.rejections - rej0)
        tr = self.tracer
        for i, st in admitted:
            self._c_admissions.inc()
            if st.req.t_admit is None:
                st.req.t_admit = time.perf_counter()
                self._h_queue.observe(st.req.queue_s)
            if tr.enabled:
                tr.begin(st.req.uid, "prefill", slot=i, cached_len=st.cached_len)
                self._phase[st.req.uid] = "prefill"

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
            if tr.enabled:
                tr.end(req.uid, "decode")
                tr.mark(req.uid, "finished", n_out=len(req.out_tokens),
                        preemptions=req.n_preempted)
                tr.end(req.uid, "req")
                self._phase.pop(req.uid, None)
            self.kv.free_slot(i)
            self._slots[i] = None
        else:
            st.last_tok = tok

    # -- main loop ------------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64).to(self.device)

    def step(self) -> bool:
        """One engine step: admit, then one flat prefill/decode call.
        Returns False when there was nothing to do."""
        self._admit()
        plan = self.sched.plan_flat(self._slots, self.kv, self.token_budget)
        while isinstance(plan, Preempt):
            self._preempt(plan.slot)
            plan = self.sched.plan_flat(self._slots, self.kv, self.token_budget)
        if plan is None:
            return False

        table = self.kv.table_view(plan.view_blocks)
        step_no = self._c_steps.value
        t0 = time.perf_counter()
        with plan_runtime.activate(self.plan):
            sel, self.kv.pools = _flat_call(
                self.cfg, self.params, self.kv.pools, table,
                self._to_device(plan.tokens), self._to_device(plan.slot),
                self._to_device(plan.pos), self._to_device(plan.emit_row))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0

        self._c_steps.inc()
        self._c_planned.inc(plan.width)
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
            tr.step(dt, step=step_no, planned=plan.width,
                    realized=plan.real_tokens,
                    prefill_tokens=plan.prefill_tokens,
                    decode_tokens=plan.decode_tokens,
                    kv_blocks=int(self.kv.blocks_in_use),
                    active_slots=sum(1 for s in self._slots if s is not None),
                    kernel=self.plan.dominant_kernel(plan.width))

        toks = None
        if plan.emit.any():
            temps = np.array([
                self._slots[i].req.temperature if plan.emit[i] else 0.0
                for i in range(self.slots)], np.float32)
            toks = self._sample(sel, temps)
        for i in range(self.slots):
            st = self._slots[i]
            if st is None or plan.n_real[i] == 0:
                continue
            self.kv.lengths[i] += int(plan.n_real[i])
            if plan.advances_prefill(i):
                if tr.enabled:
                    tr.mark(st.req.uid, "prefill_chunk",
                            n=int(plan.n_real[i]), start=st.cursor)
                st.cursor += int(plan.n_real[i])
            if plan.emit[i]:
                self._emit_token(i, st, int(toks[i]))
        return True

    def _preempt(self, i: int):
        """Recompute-style preemption: return the youngest request to the
        queue head; its prompt + generated tokens re-prefill later."""
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
        self.kv.free_slot(i)
        self._slots[i] = None
        self._queue.insert(0, st.req)
        self._c_preemptions.inc()
        st.req.n_preempted += 1

    @property
    def busy(self) -> bool:
        """True while any request is queued or resident in a slot."""
        return bool(self._queue) or any(s is not None for s in self._slots)

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

    # -- metrics --------------------------------------------------------------

    def throughput(self) -> float:
        """Steady-state decode tokens/s (pure-decode steps only)."""
        return self.stats["decode_tokens"] / max(self.stats["decode_s"], 1e-9)

    def latency_percentiles(self) -> dict:
        """{ttft_s, tpot_s, queue_s} -> {p50, p90, p99, mean, max, n}."""
        return {name: self.metrics.get(name).summary()
                for name in ("ttft_s", "tpot_s", "queue_s")}
