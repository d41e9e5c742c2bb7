"""The MLA family on the port's sharded step (DTensor) against the
reference's ``shard_map`` expert-parallel path: the checks of
tests/test_torch_sharded_moe.py on reduced deepseek-v3 (MLA with its
heads over "model", a shared expert, the MTP head; 4 experts over
("data", "model") on a (2, 2) mesh with ``expert_parallel_data``), at a
capacity factor that drops nothing and at one that drops, on 4 gloo
ranks against the reference on 4 fake CPU devices.
"""
import pytest

from test_torch_sharded_moe import (  # noqa: F401 (collected here too)
    family_runs, test_decode_on_dtensors_matches_the_reference_forward,
    test_fake_group_trace_is_what_gloo_rank_0_did,
    test_forward_matches_the_reference_shard_map,
    test_loss_and_grads_match_the_reference_jax_grad,
    test_the_dropping_cases_drop)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return family_runs("deepseek-v3", tmp_path_factory)
