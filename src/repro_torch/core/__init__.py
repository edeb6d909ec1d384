"""Decentralized-optimization core of the port: topologies, gossip
schedules and their elastic (liveness-masked) form, the packed bus and its
overlap pipeline, the gossip wire codec, mixing engines, the
decentralized optimizers (every algorithm of ``ALGORITHMS`` on trees, EDM
on the bus) and the metrics."""
from .topology import (ShiftTerm, Topology, disconnected, exp_graph,
                       fully_connected, hierarchical, matrix_lam, ring,
                       spectral_stats, torus2d)
from .schedule import (SCHEDULES, AlternatingHierarchical, GossipSchedule,
                       RoundRobinExp, StaticSchedule, make_schedule,
                       group_wire_bytes_per_step, term_wire_rows,
                       wire_bytes_per_step)
from .elastic import (DropPlan, ElasticSchedule, LivenessMask,
                      MaskedTopology, StragglerPlan, degrade_round)
from .bus import BusGroup, GroupSpec, group_specs_from_json, layout_of
from .wire import WIRE_FORMATS, WireCodec, encode_ef, make_codec
from .mixing import (GroupPlan, accumulate_f32, build_mixer,
                     make_group_mixer, make_mixer,
                     make_overlap_mixer, make_schedule_mixer, mix_dense,
                     mix_dense_sharded, mix_ppermute, mix_ranks, mix_shifts,
                     round_tables, tree_map, wire_terms)
from .optimizers import (ALGORITHMS, DecOptimizer, make_edm_bus,
                         make_edm_bus_ef, make_optimizer)
from .metrics import (agent_mean, bus_consensus, bus_grad_norm,
                      consensus_distance, tree_sqnorm)

__all__ = ["ShiftTerm", "Topology", "disconnected", "exp_graph",
           "fully_connected", "hierarchical", "matrix_lam", "ring",
           "spectral_stats", "torus2d", "SCHEDULES", "AlternatingHierarchical",
           "GossipSchedule", "RoundRobinExp", "StaticSchedule",
           "make_schedule", "term_wire_rows", "wire_bytes_per_step",
           "group_wire_bytes_per_step", "GroupSpec", "BusGroup",
           "group_specs_from_json", "layout_of", "GroupPlan", "make_group_mixer",
           "DropPlan", "ElasticSchedule", "LivenessMask", "MaskedTopology",
           "StragglerPlan", "degrade_round",
           "WIRE_FORMATS", "WireCodec", "encode_ef", "make_codec",
           "accumulate_f32", "build_mixer", "make_mixer",
           "make_overlap_mixer", "make_schedule_mixer", "mix_dense",
           "mix_dense_sharded", "mix_ppermute", "mix_ranks", "mix_shifts", "round_tables", "tree_map",
           "wire_terms", "ALGORITHMS", "DecOptimizer",
           "make_edm_bus", "make_edm_bus_ef", "make_optimizer", "agent_mean",
           "bus_consensus", "bus_grad_norm", "consensus_distance",
           "tree_sqnorm"]
