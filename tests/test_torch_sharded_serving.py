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
rank.
"""
import numpy as np
import pytest
from _torch_dist import reduced, run_ranks, serving_rank
from _torch_serving import one_torch_thread  # noqa: F401

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
