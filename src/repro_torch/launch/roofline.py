"""Roofline terms of a dry-run cell on H100 constants (port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds, analytic, on the H100 SXM
data sheet's constants (``repro_torch.core.hw``):

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = (argument + output bytes per device) / HBM_BW
    collective = 0 until the multi-device slice

FLOPs are those ``torch.utils.flop_counter``'s formulas count over the cell's
step on the meta device (``dryrun.MetaTrace``, equal to ``FlopCounterMode``'s
count), plus the operations of the hand-written
kernels, which the meta branch of each wrapper records in
``kernels.tally`` (2*n*k*m per call): the flop counter cannot see inside
them.  The meta trace is the whole, unsharded step, so under a mesh of more
than one device the FLOPs per device are the global count / chips, an ideal
split (``note`` says so).  The memory term is the reference's own sound floor:
every argument byte (weights, caches, batch) crosses HBM at least once per
step, and so does every output byte; PyTorch has no compiler estimate of
bytes accessed to take the larger of.

The reference's HLO text parsers (``hlo_program_costs``,
``collective_bytes_from_hlo``) are not ported: PyTorch has no HLO.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.core.hw import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16  # noqa: F401

IDEAL_SPLIT_NOTE = "flops/device = global meta-trace count / chips (ideal split)"
NO_COLLECTIVES_NOTE = "collective term 0: collectives come with the multi-device slice"


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bound: str
    model_flops: float            # 6*N(_active)*D global
    useful_flops_ratio: float     # model_flops / (flops_per_device * chips)
    peak_memory_bytes: float | None = None
    collectives: dict | None = None
    note: str = ""

    def to_json(self) -> dict:
        return asdict(self)


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            counts: dict, model_flops: float, memory_stats: dict | None = None,
            note: str = "") -> Roofline:
    """The three roofline terms of one cell.

    ``counts``: ``"flops"``, the flop counter's global count over the meta
    trace, and ``"kernel_ops"``, the kernel tally's operations.
    ``memory_stats``: per-device ``argument_size_in_bytes``,
    ``output_size_in_bytes`` and ``temp_size_in_bytes`` (``run_cell``'s
    ``memory_analysis``).
    """
    flops = float(counts.get("flops", 0.0) + counts.get("kernel_ops", 0.0)) / chips
    notes = [n for n in (note, NO_COLLECTIVES_NOTE,
                         IDEAL_SPLIT_NOTE if chips > 1 else "") if n]
    arg_out = 0.0
    peak_mem = None
    if memory_stats is not None:
        arg_out = float(memory_stats.get("argument_size_in_bytes", 0)
                        + memory_stats.get("output_size_in_bytes", 0))
        peak_mem = float(memory_stats.get("temp_size_in_bytes", 0) + arg_out) or None

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = arg_out / HBM_BW
    collective_s = 0.0
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bound = max(terms, key=terms.get)

    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=arg_out,
        collective_bytes_per_device=0.0,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, model_flops=model_flops,
        useful_flops_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        peak_memory_bytes=peak_mem, collectives={}, note="; ".join(notes),
    )


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), D = tokens/step.

    Decode cells process one token per sequence per step but attention reads
    the full KV cache; the 6ND convention counts only parameter FLOPs, so the
    attention-KV flops show up in the counted FLOPs and in the useful-flops
    ratio, as intended.
    """
    n = cfg.n_active_params()
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0 if shape.kind == "train" else 2.0   # fwd-only for prefill
    else:
        tokens = shape.global_batch
        mult = 2.0
    return mult * n * tokens


def format_table(rows: list[dict]) -> str:
    hdr = (f"| {'arch':26s} | {'shape':11s} | {'mesh':6s} | {'bound':10s} "
           f"| compute_s | memory_s | collect_s | useful% | note |")
    sep = "|" + "-" * (len(hdr) - 2) + "|"
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']:26s} | {r['shape']:11s} | {r['mesh']:6s} "
            f"| {r['bound']:10s} | {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {100*r['useful_flops_ratio']:7.1f} "
            f"| {r.get('note','')} |"
        )
    return "\n".join(lines)
