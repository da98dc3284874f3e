"""The load generator: a seed gives one trace; seeds share sizes and gaps
in other orders."""
import numpy as np
import pytest

from h100bench import spec
from h100bench import traffic as traffic_lib

SEED = 2**31 + 977
# The benchmark's traffic files, and a second shape: few clients, long
# prompts, short outputs (the Azure code trace's).
CODE = {"loop": "closed", "clients": 8, "requests": 200, "block": 8, "shape_seed": 31,
        "prompt_len": {"kind": "lognormal", "mean": 6.6438, "sigma": 0.5, "lo": 128, "hi": 1920},
        "output_len": {"kind": "lognormal", "mean": 2.5649, "sigma": 0.8, "lo": 4, "hi": 127}}


def _traffic(name):
    return CODE if name == "code-completion" else spec.traffic(name)


def _trace(name, seed, seconds=51.0):
    return traffic_lib.build(_traffic(name), 1000, seed, seconds)


@pytest.mark.parametrize("name", ["chat-closed", "code-completion"])
def test_same_seed_same_trace(name):
    a, b = _trace(name, SEED), _trace(name, SEED)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.due) == (y.max_new, y.due)


def _open(name):
    return {**_traffic(name), "loop": "open", "rate": 0.5, "prime_s": 10.0}


@pytest.mark.parametrize("name", ["chat-closed", "code-completion"])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_seeds_share_the_work_not_the_tokens(name, loop):
    tr = _traffic(name) if loop == "closed" else _open(name)
    a, b = (traffic_lib.build(tr, 1000, s, 51.0) for s in (SEED, SEED + 1))
    assert len(a) == len(b)
    assert [(len(x.prompt), x.max_new) for x in a] != [(len(x.prompt), x.max_new) for x in b]
    assert not np.array_equal(a[0].prompt[:8], b[0].prompt[:8])
    k = tr["block"]
    first = tr["clients"] if loop == "closed" else 0
    for items in (a, b):
        assert sorted((len(x.prompt), x.max_new) for x in items[:first]) == sorted(
            (len(x.prompt), x.max_new) for x in a[:first])
        for i in range(-(-first // k) * k, len(items) - k + 1, k):
            assert sorted((len(x.prompt), x.max_new) for x in items[i:i + k]) == sorted(
                (len(x.prompt), x.max_new) for x in a[i:i + k])
    if loop == "open":
        assert a[0].due == b[0].due == 0.0
        gaps = [np.sort(np.diff([x.due for x in items])[:k]) for items in (a, b)]
        assert np.allclose(*gaps) and np.isclose(gaps[0].sum() + 0.0, np.sum(gaps[0]))
        for items in (a, b):
            due = np.array([x.due for x in items])
            assert np.allclose(due[k::k] - due[:-k:k][:len(due[k::k])], k / tr["rate"])


def test_lengths_are_the_distributions_quantiles():
    q = traffic_lib._quantiles
    assert list(q({"kind": "uniform", "lo": 10, "hi": 13}, 4)) == [10, 11, 12, 13]
    got = q({"kind": "lognormal", "mean": np.log(100), "sigma": 0.5, "lo": 1, "hi": 10**6}, 5)
    assert got[2] == 100 and list(got) == sorted(got)
    mix = q({"kind": "mixture", "parts": [{"weight": 1, "kind": "fixed", "value": 4000},
                                         {"weight": 3, "kind": "fixed", "value": 200}]}, 8)
    assert list(mix) == [200] * 6 + [4000] * 2


def test_token_ids_span_the_vocabulary():
    items = _trace("chat-closed", SEED)
    ids = np.concatenate([x.prompt for x in items])
    assert ids.min() >= 0 and ids.max() < 1000 and ids.max() > 990
    assert ids.dtype == np.int32


def test_closed_loop_primers_are_staggered():
    tr = spec.traffic("chat-closed")
    items = traffic_lib.build(tr, 1000, SEED, 51.0)
    for key, dist in ((lambda x: x.max_new, "output_len"), (lambda x: len(x.prompt), "prompt_len")):
        first = [key(x) for x in items[:tr["clients"]]]
        rest = [key(x) for x in items[tr["clients"]:]]
        assert min(first) < tr[dist]["lo"] <= min(rest)
        assert len(set(first)) > tr["clients"] // 2
    other = traffic_lib.build(tr, 1000, SEED + 7, 51.0)[:tr["clients"]]
    assert sorted((len(x.prompt), x.max_new) for x in items[:tr["clients"]]) == sorted(
        (len(x.prompt), x.max_new) for x in other)


def test_lengths_within_their_limits():
    for name in ("chat-closed", "code-completion"):
        tr = _traffic(name)
        items = _trace(name, SEED)
        plens = [len(x.prompt) for x in items[tr["clients"]:]]
        assert tr["prompt_len"]["lo"] <= min(plens) and max(plens) <= tr["prompt_len"]["hi"]
        assert max(x.max_new for x in items) <= tr["output_len"]["hi"]


def test_any_integer_seed():
    for seed in (0, -5, 2**40 + 3):
        assert _trace("code-completion", seed)


@pytest.mark.parametrize("seed", [SEED, 2**40 + 3])
def test_more_requests_keep_the_first_400(seed):
    """Raising a closed loop's ``requests`` appends work: the first 400
    requests (lengths, order, token ids, the first wave's shares) are those
    that 400 gave, so no run that fitted 400 serves other work."""
    tr = spec.traffic("chat-closed")
    assert tr["requests"] > 400
    short = traffic_lib.build({**tr, "requests": 400}, 128256, seed, 51.0)
    long = traffic_lib.build(tr, 128256, seed, 51.0)
    assert len(long) == tr["requests"]
    for x, y in zip(short, long):
        assert (x.uid, x.max_new, x.due) == (y.uid, y.max_new, y.due)
        assert np.array_equal(x.prompt, y.prompt)


def _taken(items, clients: int, steps: int) -> int:
    """Requests a closed loop of ``clients`` slots takes in ``steps`` steps
    that each emit one token a slot (prompts cost no step: the fastest the
    loop can go through its traffic)."""
    left, taken = [x.max_new for x in items[:clients]], clients
    for _ in range(steps):
        for i in range(clients):
            left[i] -= 1
            if left[i] == 0:
                left[i], taken = items[taken].max_new, taken + 1
    return taken


@pytest.mark.parametrize("seed", [SEED, 2**40 + 3])
def test_closed_loop_outlasts_a_tenfold_rate(seed):
    """At ten times 509 tokens/s (the cell's median on an H100 once its step
    turned host-bound), over the window and ten seconds of ramp, the loop
    takes fewer requests than the traffic holds, so ``Drive`` never runs
    out."""
    tr = spec.traffic("chat-closed")
    seconds = spec.load_benchmark()["run_seconds"] + 10
    items = traffic_lib.build({**tr, "requests": 4 * tr["requests"]}, 1000, seed, seconds)
    assert _taken(items, tr["clients"], int(10 * 509 * seconds / tr["clients"])) < tr["requests"]
