"""Decentralized-optimization core of the port: topologies, gossip
schedules, the packed bus, the gossip wire codec, mixing engines, the
bus-resident EDM optimizers and bus metrics."""
from .topology import (ShiftTerm, Topology, disconnected, exp_graph,
                       fully_connected, hierarchical, matrix_lam, ring,
                       torus2d)
from .schedule import (SCHEDULES, AlternatingHierarchical, GossipSchedule,
                       RoundRobinExp, StaticSchedule, make_schedule,
                       term_wire_rows, wire_bytes_per_step)
from .wire import WIRE_FORMATS, WireCodec, encode_ef, make_codec
from .mixing import (build_mixer, make_mixer, make_schedule_mixer, mix_dense,
                     mix_ppermute, mix_shifts, wire_terms)
from .optimizers import DecOptimizer, make_edm_bus, make_edm_bus_ef
from .metrics import bus_consensus, bus_grad_norm

__all__ = ["ShiftTerm", "Topology", "disconnected", "exp_graph",
           "fully_connected", "hierarchical", "matrix_lam", "ring",
           "torus2d", "SCHEDULES", "AlternatingHierarchical",
           "GossipSchedule", "RoundRobinExp", "StaticSchedule",
           "make_schedule", "term_wire_rows", "wire_bytes_per_step",
           "WIRE_FORMATS", "WireCodec", "encode_ef", "make_codec",
           "build_mixer", "make_mixer", "make_schedule_mixer", "mix_dense",
           "mix_ppermute", "mix_shifts", "wire_terms", "DecOptimizer",
           "make_edm_bus", "make_edm_bus_ef", "bus_consensus",
           "bus_grad_norm"]
