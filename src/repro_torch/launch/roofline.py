"""Roofline terms of a dry-run cell on H100 constants (port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), in seconds, analytic, on the H100 SXM
data sheet's constants (``repro_torch.core.hw``), all per device:

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = max(bytes accessed, argument + output bytes) / HBM_BW
    collective = collective bytes / NVLINK_BW

The dry-run (``launch/dryrun.py``) traces one device's share of the step on
the meta device, as rank 0 of the mesh's world where the mesh has more than
one device.  FLOPs are those ``torch.utils.flop_counter``'s formulas count
over its local ops (``dryrun.MetaTrace``, equal to ``FlopCounterMode``'s
count), plus the operations of the hand-written kernels, which the meta
branch of each wrapper records in ``kernels.tally`` (2*n*k*m per call): the
flop counter cannot see inside them.  The memory term takes, as the
reference's does, the larger of the bytes accessed and the sound floor of
every argument byte (weights, caches, batch) and every output byte crossing
HBM once per step.  The bytes accessed are the eager step's own traffic, op
by op (``dryrun.MetaTrace``: each local op's inputs and outputs, views and
allocations excepted, plus each kernel call's operands and output from the
tally), where the reference reads XLA's estimate for its fused program: the
formula is the reference's, the counts are the port's.  The collective bytes
follow the reference's convention (``collective_bytes_from_hlo``): each
collective's result per device, by kind, an async pair once; the link rate
is NVLink 4's 450 GB/s per direction in place of the TPU's ICI link, one
link per device as the reference counts it.

The reference's HLO text parsers (``hlo_program_costs``,
``collective_bytes_from_hlo``) are not ported: PyTorch has no HLO.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

from repro_torch.core.hw import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


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
            collectives: dict | None = None, note: str = "") -> Roofline:
    """The three roofline terms of one cell, from per-device counts.

    ``counts``: ``"flops"``, the flop counter's count over the meta trace,
    ``"kernel_ops"``, the kernel tally's operations, and ``"bytes
    accessed"`` (the reference's cost key), the trace's and the tally's.
    ``memory_stats``: ``argument_size_in_bytes``, ``output_size_in_bytes``
    and ``temp_size_in_bytes`` (``run_cell``'s ``memory_analysis``).
    ``collectives``: bytes by kind (``all-reduce``, ``all-gather``, ...).
    """
    flops = float(counts.get("flops", 0.0) + counts.get("kernel_ops", 0.0))
    coll = {k: float(v) for k, v in (collectives or {}).items()}
    coll_bytes = float(sum(coll.values()))
    arg_out = 0.0
    peak_mem = None
    if memory_stats is not None:
        arg_out = float(memory_stats.get("argument_size_in_bytes", 0)
                        + memory_stats.get("output_size_in_bytes", 0))
        peak_mem = float(memory_stats.get("temp_size_in_bytes", 0) + arg_out) or None

    in_bytes = float(max(counts.get("bytes accessed", 0.0), arg_out))

    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = in_bytes / HBM_BW
    collective_s = coll_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bound = max(terms, key=terms.get)

    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=in_bytes,
        collective_bytes_per_device=coll_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bound=bound, model_flops=model_flops,
        useful_flops_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        peak_memory_bytes=peak_mem, collectives=coll, note=note,
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
