"""The sharded rungs on the card: two gloo ranks on one card
(``tests/torch_dp_worker.py`` job ``cuda_strategies``; NCCL takes one
card a rank), GPT-2 at the flash kernels' shapes (4 heads of 64, t 256).
Tensor parallelism through the K1-K3 kernels (each rank its 2 heads),
the MPMD pipeline (``schedule='1f1b_mpmd'``, a layer a stage) and LLaMA
under tp by ``llama_tp_rules`` (one KV head, whole on every rank) must
follow the same rung on dense attention, and FSDP's state must take
about half of one rank's.  Every test carries the ``cuda`` marker and
skips without a card; the file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_strategies.py -q
"""

import numpy as np
import pytest
import torch

import torch_dp_worker as w


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels run only there")
    return w.run_world(tmp_path_factory.mktemp("cuda2"), 2,
                       ["cuda_strategies"], timeout=400)


@pytest.mark.cuda
def test_tp_flash_follows_dense_attention(world2):
    for r in world2:
        got = r["cuda_strategies"]
        np.testing.assert_allclose(got["tp-flash"]["losses"],
                                   got["tp-dense"]["losses"], rtol=2e-4)
        # 2 layers x 2 steps on each rank, forward and backward
        assert got["tp-flash"]["launches"] == {
            "flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4}
        assert set(got["tp-dense"]["launches"].values()) == {0}
    assert world2[0]["cuda_strategies"]["tp-flash"]["losses"] == \
        world2[1]["cuda_strategies"]["tp-flash"]["losses"]


@pytest.mark.cuda
def test_fsdp_state_is_half_a_rank(world2):
    got = world2[0]["cuda_strategies"]
    one = got["one_rank_bytes"]
    for key in ("params", "opt_state"):
        assert 0.45 < got["fsdp"]["bytes"][key] / one[key] < 0.55, key


@pytest.mark.cuda
def test_mpmd_flash_follows_dense_attention(world2):
    """Stage 0 runs each microbatch's forward twice (the graph-free
    forward and the recompute), the last stage once."""
    for rank, r in enumerate(world2):
        got = r["cuda_strategies"]
        np.testing.assert_allclose(got["mpmd-flash"]["losses"],
                                   got["mpmd-dense"]["losses"], rtol=2e-4)
        # 1 layer x 2 microbatches x 2 steps
        assert got["mpmd-flash"]["launches"] == {
            "flash_fwd": 8 if rank == 0 else 4, "flash_dq": 4,
            "flash_dkv": 4}
        assert set(got["mpmd-dense"]["launches"].values()) == {0}


@pytest.mark.cuda
def test_llama_tp_flash_follows_dense_attention(world2):
    for r in world2:
        got = r["cuda_strategies"]
        np.testing.assert_allclose(got["llama-tp-flash"]["losses"],
                                   got["llama-tp-dense"]["losses"],
                                   rtol=2e-4)
        assert got["llama-tp-flash"]["launches"] == {
            "flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4}
        assert set(got["llama-tp-dense"]["launches"].values()) == {0}
