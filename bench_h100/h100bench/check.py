"""The comparison with the plain reference that decides a run's ``correct``.

Once the window has closed, ``memory_peak_bytes`` has been read and the
program's state is freed, a sample of the requests the program finished is
drawn from the seed, the longest of them (prompt plus served tokens)
always in it.  The reference (``bench_h100/reference/plain.py``) runs once
over each prompt with its served tokens, and the number compared is the
widest gap by which a served token's logit lies below the reference's best
at its position: 0 when every served token is the reference's first
choice, near-ties within rounding aside.  All traffic is greedy.

Beside it the run is held to having answered every request due in the
window: one that never gets its first token within a minute of the close
fails the run; a late one is late, not wrong.
"""
from __future__ import annotations

import importlib.util
import sys

from h100bench import spec
from h100bench import traffic as traffic_lib

_REF = "h100bench_reference_plain"


def sample(finished: list, served: int, seed: int) -> list:
    """Finished requests drawn from the seed, the longest (prompt plus
    served tokens) first, until they hold ``served`` served tokens or none
    is left."""
    if not finished:
        return []
    size = [len(tr.item.prompt) + len(tr.req.out_tokens) for tr in finished]
    first = max(range(len(finished)), key=lambda i: (size[i], -i))
    rest = [i for i in range(len(finished)) if i != first]
    picked = [finished[first]]
    for j in traffic_lib.rng_for(seed, "check").permutation(len(rest)):
        if sum(len(tr.req.out_tokens) for tr in picked) >= served:
            break
        picked.append(finished[rest[j]])
    return picked


def reference():
    """``bench_h100/reference/plain.py``, loaded by its path."""
    mod = sys.modules.get(_REF)
    if mod is None:
        path = spec.BENCH_DIR / "reference" / "plain.py"
        loader = importlib.util.spec_from_file_location(_REF, path)
        mod = importlib.util.module_from_spec(loader)
        sys.modules[_REF] = mod
        loader.loader.exec_module(mod)
    return mod


def gaps(c: dict, seed: int, picked: list, device) -> tuple[float, int]:
    """(widest gap, served tokens compared) of the picked requests."""
    seqs = [(tr.item.prompt.tolist(), list(tr.req.out_tokens)) for tr in picked]
    per = reference().served_gaps(c, seed, seqs, device)
    widest = max((float(g.max()) for g in per if g.numel()), default=0.0)
    return widest, sum(int(g.numel()) for g in per)
