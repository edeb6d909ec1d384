"""Trainer of the port (the packed-bus EDM path and the tree path) and
its checkpoints."""
from . import checkpoint
from .trainer import (Features, build_train_step, bus_layout_for,
                      gossip_round_step, init_state, losses_and_grads,
                      make_gossip_schedule, make_group_plans, make_topology,
                      resolve_features, resolve_group_specs,
                      tree_losses_and_grads)

__all__ = ["Features", "checkpoint", "build_train_step", "bus_layout_for",
           "gossip_round_step", "init_state", "losses_and_grads",
           "make_gossip_schedule", "make_group_plans", "make_topology",
           "resolve_features", "resolve_group_specs",
           "tree_losses_and_grads"]
