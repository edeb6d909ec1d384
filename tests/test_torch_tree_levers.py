"""The tree-resident train path's levers, JAX package against the port:
``gossip_every = 2`` (a Python branch where JAX has ``lax.cond``), the
``warmup_cosine`` LR schedule as gradient scaling (``warmup_steps`` /
``total_steps``) and a bf16 gossip payload (``gossip_dtype``).  The setup
and the tolerances are ``test_torch_tree_train.py``'s: rtol 1e-5 per step
and atol 1e-5 on the final state, except the bf16 payload's consensus
(rtol 1e-3) and state (4 bf16 ulps), where a payload element within the
reduction-order slack of a rounding boundary rounds one ulp apart.
"""
import pytest
import torch

from test_torch_tree_train import check_trajectory

torch.set_num_threads(1)  # xdist workers share the cores


@pytest.mark.parametrize("case", ["edm-fused-every2", "dmsgd-warmup-cosine",
                                  "edm-fused-gossip-bf16"])
def test_tree_lever_trajectory_matches_reference(case):
    check_trajectory(case)
