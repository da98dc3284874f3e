"""The general load generator: a traffic file's parameters and a seed in,
the cell's requests out.

A traffic file (``bench_h100/traffic/<name>.json``) names its public
``source`` and gives the loop (``open``: independent users arriving by a
schedule at ``rate`` requests per wall-clock second, after ``prime_s``
seconds of the same schedule that fill the system before the window;
``closed``: ``clients`` clients, each sending its next request the moment
the previous one completes), the prompt and output length distributions,
``block`` and ``shape_seed``.

Every seed serves the same sizes and gaps, in another order.  One block of
``block`` (prompt length, output length) pairs stands for the two
distributions: the i-th prompt length is the distribution's (i + 1/2) /
``block`` quantile, and so is some output length, paired with it by a
permutation drawn from ``shape_seed``.  In an open loop the block also
holds ``block`` gaps between arrivals, the quantiles of a Poisson
process's exponential gaps (``arrival`` ``poisson``), equal gaps
(``uniform``) or gamma draws from ``shape_seed`` (``gamma``, shape ``cv``),
scaled so that a block spans ``block / rate`` seconds.  The request list
is that block over and over, each time in an order drawn from the run's
seed (the gaps in an order of their own).  So any ``block`` requests in a
row hold the same work, and a window of some tens of requests nearly the
same work on every seed, while no two seeds share an arrival pattern.  The
run's seed also draws the token ids, from the configuration's whole
vocabulary (the weights are drawn from it elsewhere).  All requests are
greedy, with no stop token: the work does not depend on what is generated.

A length distribution is ``fixed`` (``value``), ``uniform`` (``lo`` to
``hi``), ``lognormal`` (``mean`` and ``sigma`` of the log, clipped to
``lo``, ``hi``) or a ``mixture`` of such ``parts``, each with a
``weight``: the block's pairs are shared out among the parts by weight.

A closed loop's first ``clients`` requests fill every slot at once.  They
stand for requests already in flight in a loop that has been running for a
while: each keeps a staggered share (1/2n, 3/2n, ... , tied to the block's
pairs and not to the order) of its prompt and of its output still to do,
so that the slots neither start nor finish together, and the ramp before
the window prefills half the prompt tokens a cold start would.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


def _quantiles(dist: dict, n: int) -> np.ndarray:
    """The (i + 1/2) / n quantiles, i < n, of a length distribution, in
    ascending order."""
    kind = dist.get("kind", "fixed")
    q = (np.arange(n) + 0.5) / n
    if kind == "fixed":
        out = np.full(n, int(dist["value"]))
    elif kind == "uniform":
        lo, hi = int(dist["lo"]), int(dist["hi"])
        out = lo + np.floor(q * (hi - lo + 1))
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in q])
        out = np.clip(np.round(np.exp(float(dist["mean"]) + float(dist["sigma"]) * z)),
                      int(dist.get("lo", 1)), int(dist["hi"]))
    elif kind == "mixture":
        w = np.array([float(p["weight"]) for p in dist["parts"]])
        share = w / w.sum() * n
        counts = np.floor(share).astype(int)
        for i in np.argsort(counts - share)[:n - counts.sum()]:
            counts[i] += 1
        out = np.sort(np.concatenate([_quantiles(p, k) for p, k in zip(dist["parts"], counts)]))
    else:
        raise ValueError(f"unknown length kind {kind!r}")
    if (out < 1).any():
        raise ValueError(f"{kind} length distribution has a length < 1")
    return out.astype(np.int64)


def _gaps(tr: dict, n: int, shape: np.random.Generator) -> np.ndarray:
    """``n`` gaps (s) between arrivals that together span n / rate."""
    kind = tr.get("arrival", "poisson")
    if kind == "poisson":
        g = -np.log1p(-(np.arange(n) + 0.5) / n)
    elif kind == "uniform":
        g = np.ones(n)
    elif kind == "gamma":
        cv = float(tr.get("cv", 0.25))
        if cv <= 0:
            raise ValueError(f"gamma cv must be > 0, got {cv}")
        g = shape.gamma(shape=cv, scale=1.0 / cv, size=n)
    else:
        raise ValueError(f"unknown arrival kind {kind!r}")
    return g / g.sum() * n / float(tr["rate"])


def rng_for(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator from the run's seed (any integer) and a tag."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return np.random.default_rng(int.from_bytes(digest[:16], "little"))


@dataclass
class Item:
    """One request: ``due`` in seconds from the schedule's start (an open
    loop; None in a closed loop, where a client sends it when its previous
    request completes)."""
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int
    due: float | None = None


def longest(tr: dict) -> int:
    """The most cache positions one request can take: its longest prompt
    plus its longest output."""
    return int(tr["prompt_len"]["hi"]) + int(tr["output_len"]["hi"])


def _block(tr: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """The block every seed shares: its prompt and output lengths and, in
    an open loop, its gaps (s)."""
    b = int(tr["block"])
    shape = np.random.default_rng(int(tr["shape_seed"]))
    plens = _quantiles(tr["prompt_len"], b)
    olens = _quantiles(tr["output_len"], b)[shape.permutation(b)]
    gaps = _gaps(tr, b, shape) if tr["loop"] == "open" else None
    return plens, olens, gaps


def build(tr: dict, vocab: int, seed: int, seconds: float) -> list[Item]:
    """The requests of one run, in the order they are sent: enough blocks
    to cover the prime and the window of an open loop (requests due past
    the window are never sent), ``requests`` of a closed loop."""
    plens, olens, gaps = _block(tr)
    b = len(plens)
    order = rng_for(seed, "order")
    if tr["loop"] == "open":
        span = float(tr["prime_s"]) + seconds
        n = b * (int(span * float(tr["rate"]) / b) + 2)
    elif tr["loop"] == "closed":
        n = int(tr["requests"])
    else:
        raise ValueError(f"loop {tr['loop']!r} must be 'open' or 'closed'")
    idx = np.concatenate([order.permutation(b) for _ in range(-(-n // b))])[:n]
    p, o = plens[idx], olens[idx]
    due = [None] * n
    if gaps is not None:
        g = np.concatenate([gaps[order.permutation(b)] for _ in range(-(-n // b))])[:n]
        due = np.cumsum(g) - g
    if tr["loop"] == "closed":
        c = int(tr["clients"])
        # The k-th copy of the block's j-th pair has one share, whatever the order.
        rank = np.random.default_rng(int(tr["shape_seed"])).permutation(-(-c // b) * b)
        share = (rank[np.arange(c) // b * b + idx[:c]] + 0.5) / len(rank)
        p[:c] = np.maximum(1, np.ceil(share * p[:c])).astype(np.int64)
        o[:c] = np.maximum(1, np.ceil(share * o[:c])).astype(np.int64)
    ids = rng_for(seed, "tokens").integers(0, vocab, size=int(p.sum()), dtype=np.int32)
    cuts = np.cumsum(p)[:-1]
    return [Item(uid=i, prompt=q, max_new=int(m), due=None if t is None else float(t))
            for i, (q, m, t) in enumerate(zip(np.split(ids, cuts), o, due))]
