"""Compile-once / serve-many execution plans (port of ``repro/plan/plan.py``,
the paper's Fig. 5 offline phase).

``compile_plan(frozen_params, batch_profile)`` walks a frozen params tree
once, costs every registered kernel per BitLinear layer over a few n-buckets
(decode widths and prefill step widths) against the H100 constants, and
freezes the argmin into a :class:`ModelPlan`, which

* maps ``layer name -> {n_bucket -> LayerPlan(kernel, dataflow, tile_sizes,
  est_time_s, bound, density)}``;
* round-trips through JSON (``to_json``/``from_json``) in the reference's
  format, so a plan saved by either package loads in the other;
* resolves runtime shapes to buckets (``lookup`` by name, ``lookup_shape``
  by (k, m) for the in-model dispatch that has no layer names) with Python
  dicts only.

The serving engine compiles (or loads) one plan at init and activates it
around every step (``repro_torch.plan.runtime``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Mapping

import torch

from repro_torch.plan import registry

PLAN_VERSION = 1

# Marks a (k, m) shape shared by layers whose plans DISAGREE: the nameless
# shape-keyed serve-path lookup cannot tell such layers apart, so it returns
# None (default realization) rather than silently serving one layer with
# another's plan.
_AMBIGUOUS = "<ambiguous>"


def _pad8(k: int) -> int:
    """Bitplane-padded K (planes store ceil(K/8) bytes; ragged tails decode
    to 0).  Plan shapes are keyed on this so packed-dict walks (which only
    see the padded planes) and serve-time lookups (which see the true K)
    agree."""
    return -(-k // 8) * 8


@dataclasses.dataclass(frozen=True)
class BatchProfile:
    """The n-buckets a deployment will actually run.

    ``decode_ns`` are flattened token counts of pure-decode steps (slots
    decoding in lockstep), ``prefill_ns`` the chunked-prefill step widths.
    """

    decode_ns: tuple[int, ...] = (1, 2, 4, 8)
    prefill_ns: tuple[int, ...] = (16, 128)

    @property
    def buckets(self) -> tuple[int, ...]:
        return tuple(sorted(set(self.decode_ns) | set(self.prefill_ns)))


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One (layer, n-bucket) decision: what to run and why."""

    kernel: str
    dataflow: str                 # 'AP' | 'OP'
    tile_sizes: tuple[int, ...]
    est_time_s: float
    bound: str                    # 'compute' | 'memory'
    density: float

    @staticmethod
    def from_dict(d: dict) -> "LayerPlan":
        return LayerPlan(kernel=d["kernel"], dataflow=d["dataflow"],
                         tile_sizes=tuple(d["tile_sizes"]),
                         est_time_s=float(d["est_time_s"]), bound=d["bound"],
                         density=float(d["density"]))


@dataclasses.dataclass(frozen=True, eq=True)
class ModelPlan:
    """Whole-model execution plan: layer name -> n-bucket -> LayerPlan."""

    buckets: tuple[int, ...]
    # name -> (k, m, c)
    shapes: Mapping[str, tuple[int, int, int]]
    # name -> {n_bucket -> LayerPlan}
    layers: Mapping[str, Mapping[int, LayerPlan]]
    version: int = PLAN_VERSION
    # (k, m) -> layer name, for the in-model dispatch (derived, not compared)
    _shape_index: dict = dataclasses.field(
        init=False, repr=False, compare=False, default_factory=dict)

    def __post_init__(self):
        # Layers agree for lookup purposes when their per-bucket DECISIONS
        # (kernel/dataflow/tiles) match; telemetry floats (density,
        # est_time_s) legitimately differ per layer and must not poison the
        # shared-shape key.
        def decisions(name):
            return tuple(sorted(
                (n, lp.kernel, lp.dataflow, lp.tile_sizes)
                for n, lp in self.layers.get(name, {}).items()))

        idx = {}
        for name, (k, m, _c) in self.shapes.items():
            key = (_pad8(k), m)
            other = idx.get(key)
            if other is None:
                idx[key] = name
            elif other != _AMBIGUOUS and decisions(other) != decisions(name):
                # Same shape, different decisions: a nameless lookup could
                # misapply one layer's plan to the other — poison the key.
                idx[key] = _AMBIGUOUS
        object.__setattr__(self, "_shape_index", idx)

    # -- resolution ----------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n, else the largest (prefill overflow)."""
        ge = [b for b in self.buckets if b >= n]
        return min(ge) if ge else max(self.buckets)

    def lookup(self, name: str, n: int) -> LayerPlan | None:
        by_bucket = self.layers.get(name)
        if not by_bucket:
            return None
        b = self.bucket_for(n)
        if b in by_bucket:
            return by_bucket[b]
        # shape-plans (layer_plan wrapper) carry per-layer buckets
        ks = sorted(by_bucket)
        ge = [x for x in ks if x >= n]
        return by_bucket[min(ge) if ge else max(ks)]

    def lookup_shape(self, k: int, m: int, n: int) -> LayerPlan | None:
        """Nameless (serve-path) lookup by weight shape; ``k`` may be the
        true or the bitplane-padded K.  Returns None when no layer has this
        shape OR when same-shape layers carry conflicting plans (the default
        realization is always correct; misapplying another layer's plan is
        not)."""
        name = self._shape_index.get((_pad8(k), m))
        if name is None or name == _AMBIGUOUS:
            return None
        return self.lookup(name, n)

    def shape_conflicts(self) -> tuple[tuple[int, int], ...]:
        """(k, m) shapes whose layers disagree — served by the default
        realization; surfaced in engine telemetry."""
        return tuple(sorted(
            key for key, name in self._shape_index.items()
            if name == _AMBIGUOUS))

    def coverage(self, params, n: int | None = None) -> tuple[int, int]:
        """(matched, total) BitLinear layers of ``params`` whose shapes this
        plan resolves — the sanity check for a plan loaded from disk: a plan
        saved for a different model silently resolves nothing, so callers
        (e.g. the serving engine) compare matched against total and warn."""
        if n is None:
            n = self.buckets[0] if self.buckets else 1
        matched = total = 0
        for _name, k, m, *_ in _iter_bitlinear_layers(params, 4):
            total += 1
            if self.lookup_shape(k, m, n) is not None:
                matched += 1
        return matched, total

    # -- telemetry -----------------------------------------------------------

    def kernel_counts(self, n: int) -> dict[str, int]:
        """How many layers run each kernel at step width n."""
        counts: dict[str, int] = {}
        for name in self.layers:
            lp = self.lookup(name, n)
            if lp is not None:
                counts[lp.kernel] = counts.get(lp.kernel, 0) + 1
        return counts

    def dominant_kernel(self, n: int) -> str:
        """The kernel serving the most layers at step width n."""
        counts = self.kernel_counts(n)
        return max(counts, key=counts.get) if counts else "none"

    def summary(self) -> dict:
        return {
            "layers": len(self.layers),
            "buckets": list(self.buckets),
            "decode_kernel": self.dominant_kernel(1),
            "prefill_kernel": self.dominant_kernel(max(self.buckets)),
        }

    # -- persistence ---------------------------------------------------------

    def to_json(self, indent: int | None = 2) -> str:
        payload = {
            "version": self.version,
            "buckets": list(self.buckets),
            "layers": {
                name: {
                    "shape": list(self.shapes[name]),
                    "buckets": {
                        str(n): dataclasses.asdict(lp)
                        for n, lp in sorted(self.layers[name].items())
                    },
                }
                for name in sorted(self.layers)
            },
        }
        return json.dumps(payload, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ModelPlan":
        payload = json.loads(text)
        if payload.get("version") != PLAN_VERSION:
            raise ValueError(
                f"plan version {payload.get('version')!r} != {PLAN_VERSION}")
        shapes, layers = {}, {}
        for name, entry in payload["layers"].items():
            shapes[name] = tuple(entry["shape"])
            layers[name] = {int(n): LayerPlan.from_dict(d)
                            for n, d in entry["buckets"].items()}
        return cls(buckets=tuple(payload["buckets"]), shapes=shapes,
                   layers=layers, version=payload["version"])

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "ModelPlan":
        with open(path) as f:
            return cls.from_json(f.read())


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def _iter_bitlinear_layers(params, default_c: int):
    """Yield (name, k, m, c, density, block_density, sparse_ok, block_shape)
    per BitLinear layer.

    Understands ``core.bitlinear.FrozenBitLinear`` layers, packed dicts
    (``layers.pack_linear`` / ``freeze_params`` output) and latent ``{'w'}``
    dicts.  A stacked weight is one entry: every slice shares a shape and
    therefore a plan; the stamped density leaves are averaged.
    ``sparse_ok`` is the sparse kernels the layer's stored formats can serve
    (``sp_*`` padded-pool leaves support ``tsar_sparse_padded`` only) and
    ``block_shape`` the format's tiling, so a plan never commits to a sparse
    kernel the layer cannot run.
    """
    def mean(leaf) -> float:
        return float(torch.mean(leaf.to(torch.float32)))

    def walk(node, path):
        if hasattr(node, "packed") and hasattr(node, "c"):   # FrozenBitLinear
            k, m = node.shape
            sparse_ok = tuple(kn for kn in registry.SPARSE_KERNELS
                              if registry.get(kn).supports(node))
            sidecar = node.sparse if node.sparse is not None else node.padded
            yield (path or "layer", _pad8(k), m, int(node.c),
                   float(node.density) if node.density is not None
                   else registry.DEFAULT_DENSITY,
                   float(node.block_density)
                   if node.block_density is not None else None,
                   sparse_ok,
                   sidecar.block_shape if sidecar is not None else None)
            return
        if not isinstance(node, dict):
            return
        keys = set(node)
        if {"sign", "zero"} <= keys:
            ps = node["sign"].shape
            k, m = ps[-2] * 8, ps[-1]
            density = (mean(node["density"]) if "density" in node
                       else registry.DEFAULT_DENSITY)
            block_density = None
            sparse_ok: tuple = ()
            block_shape = None
            if "sp_sign" in keys:
                sparse_ok = ("tsar_sparse_padded",)
                sp = node["sp_sign"].shape
                block_shape = (sp[-2] * 8, sp[-1])
                if "block_density" in keys:
                    block_density = mean(node["block_density"])
            yield (path, k, m, default_c, density, block_density,
                   sparse_ok, block_shape)
            return
        if keys == {"w"}:
            from repro_torch.core import ternary

            k, m = node["w"].shape[-2:]
            t, _ = ternary.absmean_ternarize(node["w"])
            density = mean(ternary.ternary_density(t))
            yield (path, _pad8(k), m, default_c, density, None, (), None)
            return
        for key in sorted(node):
            yield from walk(node[key], f"{path}/{key}" if path else str(key))

    yield from walk(params, "")


def compile_plan(frozen_params, batch_profile: BatchProfile | None = None,
                 *, default_c: int = 4) -> ModelPlan:
    """One-time, whole-model kernel/dataflow planning.

    Walks the frozen params tree, and for every BitLinear layer and every
    n-bucket in ``batch_profile`` runs the registry-backed selector
    (``core.dataflow.select_kernel``) with that layer's measured density —
    per-layer ``c`` and densities, not one global default.  The result is the
    whole offline phase as one artifact.
    """
    from repro_torch.core import dataflow  # lazy: core imports plan.registry

    profile = batch_profile or BatchProfile()
    shapes: dict[str, tuple[int, int, int]] = {}
    layers: dict[str, dict[int, LayerPlan]] = {}
    for (name, k, m, c, density, block_density, sparse_ok,
         block_shape) in _iter_bitlinear_layers(frozen_params, default_c):
        shapes[name] = (k, m, c)
        kw: dict = {"sparse_ok": sparse_ok}
        if block_density is not None:
            kw["block_density"] = block_density
        if block_shape is not None:
            kw["block_shape"] = block_shape
        per_bucket: dict[int, LayerPlan] = {}
        for n in profile.buckets:
            choice = dataflow.select_kernel(
                n=n, k=k, m=m, c=c, density=density, **kw)
            per_bucket[n] = LayerPlan(
                kernel=choice.kernel,
                dataflow=choice.dataflow,
                tile_sizes=tuple(registry.get(choice.kernel).tiles(n, k, m, c)),
                est_time_s=choice.est_time_s,
                bound=choice.bound,
                density=density,
            )
        layers[name] = per_bucket
    return ModelPlan(buckets=profile.buckets, shapes=shapes, layers=layers)


def compile_plan_from_shapes(shapes: Mapping[str, tuple | dict],
                             c: int = 4) -> ModelPlan:
    """Plan from explicit per-layer shapes (the ``dataflow.layer_plan`` path).

    Each spec is ``(n, k, m)``, ``(n, k, m, c)``, or a dict with keys
    ``n, k, m`` and optional ``c, density, block_density`` — per-layer ``c``
    and measured densities, so e.g. MoE expert layers with a different LUT
    block size cost correctly.
    """
    from repro_torch.core import dataflow

    plan_shapes: dict[str, tuple[int, int, int]] = {}
    layers: dict[str, dict[int, LayerPlan]] = {}
    buckets: set[int] = set()
    for name, spec in shapes.items():
        if isinstance(spec, dict):
            n, k, m = spec["n"], spec["k"], spec["m"]
            lc = spec.get("c", c)
            kw = {key: spec[key] for key in ("density", "block_density")
                  if key in spec}
        else:
            n, k, m = spec[:3]
            lc = spec[3] if len(spec) > 3 else c
            kw = {}
        choice = dataflow.select_kernel(n=n, k=k, m=m, c=lc, **kw)
        plan_shapes[name] = (k, m, lc)
        layers[name] = {n: LayerPlan(
            kernel=choice.kernel, dataflow=choice.dataflow,
            tile_sizes=tuple(registry.get(choice.kernel).tiles(n, k, m, lc)),
            est_time_s=choice.est_time_s, bound=choice.bound,
            density=choice.detail.get("density", registry.DEFAULT_DENSITY),
        )}
        buckets.add(n)
    return ModelPlan(buckets=tuple(sorted(buckets)), shapes=plan_shapes,
                     layers=layers)


def format_plan(plan: ModelPlan, max_rows: int = 40) -> str:
    """Human-readable per-layer, per-bucket table."""
    lines = [f"| {'layer':32s} | {'(k, m, c)':>18s} | {'n':>5s} "
             f"| {'kernel':11s} | df | bound   | est(us) |"]
    lines.append("|" + "-" * 96 + "|")
    rows = 0
    for name in sorted(plan.layers):
        k, m, c = plan.shapes[name]
        for n, lp in sorted(plan.layers[name].items()):
            if rows >= max_rows:
                lines.append(f"... ({len(plan.layers)} layers x "
                             f"{len(plan.buckets)} buckets total)")
                return "\n".join(lines)
            lines.append(
                f"| {name[-32:]:32s} | {str((k, m, c)):>18s} | {n:5d} "
                f"| {lp.kernel:11s} | {lp.dataflow} | {lp.bound:7s} "
                f"| {lp.est_time_s * 1e6:7.2f} |")
            rows += 1
    return "\n".join(lines)
