"""Decentralized-optimization core of the port: topologies, the packed
bus, mixing engines, the bus-resident EDM optimizer and bus metrics."""
from .topology import (ShiftTerm, Topology, disconnected, exp_graph,
                       fully_connected, hierarchical, ring, torus2d)
from .mixing import build_mixer, make_mixer, mix_dense, mix_ppermute, mix_shifts
from .optimizers import DecOptimizer, make_edm_bus
from .metrics import bus_consensus, bus_grad_norm

__all__ = ["ShiftTerm", "Topology", "disconnected", "exp_graph",
           "fully_connected", "hierarchical", "ring", "torus2d",
           "build_mixer", "make_mixer", "mix_dense", "mix_ppermute",
           "mix_shifts", "DecOptimizer", "make_edm_bus", "bus_consensus",
           "bus_grad_norm"]
