"""The serving cells on a device mesh (``launch.dryrun.mesh_cells``) against
the port's unsharded ``prefill`` / ``decode_step``, on a (2, 2) mesh of
gloo ranks on the CPU.

Reduced bitnet-2b-4t, frozen: a prefill and 4 greedy decode steps whose
logits are ``torch.equal`` to the unsharded cells' on every rank (the
row-parallel projections reduce exact integers), the same greedy tokens,
and every projection through ``tsar_matmul``'s wrapper on its local
shards: per step 2 layers x 7 calls, with the column-parallel ones on half
of M, the row-parallel ones on half of K, and the batch split over 'data'.
Reduced deepseek-moe-16b: the same, through the experts' expert-parallel
branch (counted), logits within 2^-8 and the greedy tokens equal.  Reduced
mamba2-780m, hymba-1.5b and whisper-tiny (zero-mean random frames): logits
``torch.equal`` and the same tokens, through the SSM mixer per rank on its
batch rows, the cross-attention context per rank and the embedding rows per
rank.  Reduced qwen3-32b (4 query heads, 2 KV heads) on a (1, 4) mesh:
logits ``torch.equal`` and the same tokens, each rank's attention core on
its one query head against the KV head it belongs to.

The split-KV scheme (a cache split on its sequence over 'model', reduced
bitnet-2b-4t with one KV head): decode logits and tokens ``torch.equal``
to the unsharded cells', every decode layer through ``attend_split``,
including a step where one rank's block holds no live position; on the
fake world no all-gather of the step is as large as one layer's K block;
``attend_split`` on 2 and 3 ranks against ``attend_core``, masked blocks
and a row masked everywhere included.
"""
import numpy as np
import pytest
import torch
from _torch_dist import (DRYRUN_CELLS, reduced, run_ranks, serving_rank,
                         split_attention_rank)
from _torch_serving import one_torch_thread  # noqa: F401

import repro_torch.configs as configs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROMPT, STEPS = 8, 4


def _tokens(logits: list) -> list:
    return [np.argmax(x, axis=-1).tolist() for x in logits]


def test_dense_cells_on_mesh_equal_unsharded(tmp_path):
    cfg = reduced("bitnet-2b-4t")
    outs = run_ranks(serving_rank, 4, tmp_path, "bitnet-2b-4t", PROMPT, STEPS)
    d, hd, f = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.d_ff
    kvd = cfg.n_kv_heads * cfg.head_dim
    for rank, res in enumerate(outs):
        assert len(res["mesh"]) == STEPS + 1
        for got, want in zip(res["mesh"], res["plain"]):
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        assert _tokens(res["mesh"]) == _tokens(res["plain"])
        assert res["ep_calls"] == 0
        for i, calls in enumerate(res["calls"]):
            rows = PROMPT if i == 0 else 1          # 2 slots split over 'data'
            assert sorted(calls) == sorted(cfg.n_layers * [
                (rows, d, hd // 2), (rows, d, kvd // 2), (rows, d, kvd // 2),   # wq wk wv
                (rows, hd // 2, d),                                             # wo
                (rows, d, f // 2), (rows, d, f // 2),                           # gate up
                (rows, f // 2, d)]), f"rank {rank} step {i}"                    # down


def test_moe_cells_on_mesh_run_expert_parallel(tmp_path):
    cfg = reduced("deepseek-moe-16b")
    outs = run_ranks(serving_rank, 4, tmp_path, "deepseek-moe-16b", PROMPT, STEPS)
    for rank, res in enumerate(outs):
        for got, want in zip(res["mesh"], res["plain"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8, err_msg=f"rank {rank}")
        assert _tokens(res["mesh"]) == _tokens(res["plain"])
        # Every MoE layer of the prefill and of each decode step.
        assert res["ep_calls"] == cfg.n_layers * (STEPS + 1)
        assert all(len(c) == 7 * cfg.n_layers for c in res["calls"])


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b", "whisper-tiny"])
def test_ssm_hybrid_encdec_cells_on_mesh_equal_unsharded(tmp_path, arch):
    """``ssm._mixer`` runs the scan per rank on its rows (every feature
    whole), ``layers.context`` the cross-attention per rank and
    ``transformer.embed_rows`` the token rows per rank: each rank's logits
    equal the unsharded cells', and so do the greedy tokens; every step
    runs its projections through ``tsar_matmul``."""
    cfg = reduced(arch)
    outs = run_ranks(serving_rank, 4, tmp_path, arch, PROMPT, STEPS)
    for rank, res in enumerate(outs):
        assert len(res["mesh"]) == STEPS + 1
        for got, want in zip(res["mesh"], res["plain"]):
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        assert _tokens(res["mesh"]) == _tokens(res["plain"])
        assert all(len(c) >= 2 * cfg.n_layers for c in res["calls"])


def test_query_heads_stay_split_where_kv_heads_do_not_divide(tmp_path):
    """Reduced qwen3-32b (qk-norm; 4 query heads, 2 KV heads) on a (1, 4)
    mesh: the query heads split over 'model' and the 2 KV heads do not, so
    each rank attends its one query head against the KV head that head
    belongs to.  Prefill and 4 decode steps give logits ``torch.equal`` to
    the unsharded cells' and the same greedy tokens; every call of the
    attention core on every rank holds 1 query head, not 4."""
    cfg = reduced("qwen3-32b")
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2) and cfg.qk_norm
    outs = run_ranks(serving_rank, 4, tmp_path, "qwen3-32b", PROMPT, STEPS, None, (1, 4))
    for rank, res in enumerate(outs):
        assert len(res["mesh"]) == STEPS + 1
        for got, want in zip(res["mesh"], res["plain"]):
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        assert _tokens(res["mesh"]) == _tokens(res["plain"])
        assert res["core_heads"] == [1] * cfg.n_layers * (STEPS + 1), f"rank {rank}"
        assert res["split_kv_calls"] == 0


def test_split_kv_decode_on_mesh_equals_unsharded(tmp_path):
    """One KV head does not divide 'model' (2), so the cache (max_len 10)
    is split on its sequence: each rank writes only its block's rows and
    attends over its block, the partial softmax combined by all-reduce.
    The first decode step (position 4) leaves the second block with no
    live position."""
    prompt, steps = 4, 5
    cfg = reduced("bitnet-2b-4t", n_kv_heads=1)
    outs = run_ranks(serving_rank, 4, tmp_path, "bitnet-2b-4t", prompt, steps,
                     {"n_kv_heads": 1})
    for rank, res in enumerate(outs):
        assert len(res["mesh"]) == steps + 1
        for got, want in zip(res["mesh"], res["plain"]):
            np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        assert _tokens(res["mesh"]) == _tokens(res["plain"])
        assert res["split_kv_calls"] == cfg.n_layers * steps
        assert all(len(c) == 7 * cfg.n_layers for c in res["calls"])


class _EachCollective(dryrun.MetaTrace):
    """The dry-run's trace, keeping each collective's (kind, bytes)."""

    def __init__(self):
        super().__init__(set())
        self.each = []

    def _collective(self, func, args, out):
        before = dict(self.collectives)
        super()._collective(func, args, out)
        self.each += [(k, v - before.get(k, 0)) for k, v in self.collectives.items()
                      if v != before.get(k, 0)]


def test_split_kv_decode_gathers_no_cache():
    """Rank 0 of a fake (2, 2) world, the dry-run's split-KV decode cell
    at 256 positions (so that a layer's cache outweighs the logits):
    attention all-reduces its partials, and no all-gather moves as much as
    one layer's K cache on a data slice (what the gathered layout moved
    twice per layer and per K and V)."""
    arch, fields, kw, overrides = DRYRUN_CELLS["splitkv_decode"]
    cfg, shape = reduced(arch, **overrides), configs.ShapeConfig(fields[0], 256, *fields[2:])
    mesh = make_mesh((2, 2), ("data", "model"))
    with fake_world(mesh) as dm:
        lowered, _ = dryrun.lower_cell(cfg, shape, mesh, device_mesh=dm, **kw)
        trace = _EachCollective()
        with trace:
            lowered.run()
    k_block = (shape.global_batch // 2) * shape.seq_len * cfg.n_kv_heads * cfg.head_dim * 2
    gathers = [b for kind, b in trace.each if kind == "all-gather"]
    assert gathers and max(gathers) < k_block, (gathers, k_block)
    assert trace.collectives["all-reduce"] > 0


@pytest.mark.parametrize("n", [2, 3])
def test_attend_split_equals_attend_core(tmp_path, n):
    """Float64 contexts within 1e-12 of the unsharded core, float32 ones
    equal; a wholly masked block weighs nothing and a row masked
    everywhere is the unsharded call's (uniform), never NaN."""
    outs = run_ranks(split_attention_rank, n, tmp_path)
    for res in outs:
        f64, f32 = res[str(torch.float64)], res[str(torch.float32)]
        assert np.isfinite(f64["split"]).all()
        np.testing.assert_allclose(f64["split"], f64["whole"], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(f32["split"], f32["whole"])
        np.testing.assert_array_equal(res[str(torch.float64)]["split"],
                                      outs[0][str(torch.float64)]["split"])
