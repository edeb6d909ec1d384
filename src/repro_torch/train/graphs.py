"""The bus train step as CUDA graphs: the port's twin of the reference
CLI's ``jax.jit(build_train_step(...))``.

An eager bus step is some 25,000 kernel launches from Python, and the host
takes several times the device's time to issue them.  A captured step is
one ``cudaGraphLaunch``.  :func:`graph_train_step` wraps the eager step
built by :func:`repro_torch.train.build_train_step` into a callable with
its signature, ``(state, batch) -> (state, metrics)``, whose body copies
each of the batch's tensors (the tokens and, for a VLM, the frontend
embeddings) into a static buffer of its own and replays a graph of
:class:`~repro_torch.train.trainer.StaticBusStep`:

* **One static state.**  The captured step writes x', m', ψ' (and e') over
  the state's own buffers: the EDM kernel writes m' and ψ' in place as the
  eager step does, and the fused combine writes the new x into x's buffer
  (x is dead once φ exists; a mix that is not fused is copied there).
  The returned state holds the same buffers.
* **What changes between steps** is not recaptured.  The schedule's round
  and whether the step gossips key one graph each (at most 2 × period
  graphs without groups), captured the first time their key comes up,
  all in one shared memory pool; each graph's metrics stay allocated in
  the pool, so no capture reuses another's outputs, and they are copied
  out after every replay.  The ``warmup_cosine`` scale lives in a device
  scalar written before each replay.
* **Policy groups** (DESIGN §12): a grouped step's key is every
  gossiping group's (mixes this step, round) pair, so the graphs number
  at most the product over those groups of period × cadence (the train
  CLI prints how many it captured; nothing caps them).  Each graph holds
  the combines of the groups that mix on its key, writing into x's rows
  in place, and the copies of the rest; an int8 group's stateless encode
  runs inside the graph.
* **Churn** (an :class:`~repro_torch.core.elastic.ElasticSchedule`) is
  more rounds: each (epoch, base round) is a round index of its own, so
  a degraded round has its own graph, whose source-table kernel reads
  the round's tables from device buffers made at its eager first step.
* **Overlap.**  The pipeline's ``slot`` is part of the static state and
  its parity keys the graphs too (one graph per parity: the live and the
  spare slot trade places every step).  Under a straggler plan the key
  also says whether a slot is late, and before every replay the step's
  source table, late slots swapped in, is written into the device
  buffers the captured combine reads (``StaticBusStep.prepare``).
* **The first step of a key runs eagerly**, on the capture's side stream:
  it is the warm-up every capture needs (library handles, the autograd
  engine, the kernels' first load) and a real step of the run.  Then the
  same step is captured, which launches nothing.
* **Launch counts.**  ``launch_counts()`` counts the kernels the wrappers
  ran: the eager first step of each key, not the capture (which runs
  nothing) and not the replays (which no wrapper sees).  A replay's
  kernels are read from a device trace; the step's ``replays`` says how
  many replays it made.

A capture that fails raises; nothing falls back to the eager step.  CUDA
graphs exist on the card only: CPU states raise, and the CPU runs the
eager step.  The tree path is not captured yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

__all__ = ["GraphedTrainStep", "graph_train_step"]


class GraphedTrainStep:
    """A bus step replayed from CUDA graphs over a static state: call it
    as the eager step, ``(state, batch) -> (state, metrics)``.  ``replays``
    counts the steps that replayed a graph.  (A class, not a closure: a
    function that counted on its own attribute would hold itself in a
    reference cycle, and with it every graph's memory pool until the
    garbage collector ran.)"""

    def __init__(self, static, state: Dict, batch: Dict):
        x = state["params"]
        self.static, self.x, self.opt = static, x, dict(state["opt"])
        pipe = state.get("pipeline")
        self.slot = None if pipe is None else pipe["slot"]
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.lr_scale = (torch.zeros((), dtype=torch.float32,
                                     device=x.device)
                         if static.lr_schedule is not None else None)
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device=x.device)
        self.graphs: Dict[Tuple, tuple] = {}
        self.replays = 0

    def _capture(self, st: Dict, key) -> Dict:
        """Run the step eagerly on the side stream (the warm-up, a real
        step), then capture it; returns the eager step's metrics."""
        run, side, dev = self.static.run, self.side, self.x.device
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            metrics = run(st, self.batch, self.lr_scale)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                captured = run(st, self.batch, self.lr_scale)
        except RuntimeError as err:
            raise RuntimeError(f"capturing the bus train step (key {key}: "
                               f"round, gossip, ...) failed: {err}"
                               ) from err
        self.graphs[key] = (graph, captured)
        return metrics

    def __call__(self, st: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        pipe = st.get("pipeline")
        if st["params"] is not self.x or any(
                st["opt"][k] is not v for k, v in self.opt.items()) or (
                    (pipe is None) != (self.slot is None)) or (
                    pipe is not None and pipe["slot"] is not self.slot):
            raise ValueError("a graphed step runs on its static state: pass "
                             "the state the previous call returned")
        t = int(st["step"])
        if batch.keys() != self.batch.keys():
            raise ValueError(f"a graphed step takes the batch keys it was "
                             f"built with, {sorted(self.batch)}; got "
                             f"{sorted(batch)}")
        for k, buf in self.batch.items():
            buf.copy_(batch[k])
        if self.lr_scale is not None:
            self.lr_scale.copy_(self.static.lr_schedule(t))
        if self.static.prepare is not None:
            self.static.prepare(t, self.x.device)
        key = self.static.key(t)
        if pipe is not None:
            key = key + (int(pipe["parity"]),)
        if key not in self.graphs:
            metrics = self._capture(st, key)
        else:
            graph, captured = self.graphs[key]
            graph.replay()
            self.replays += 1
            metrics = {k: v.clone() for k, v in captured.items()}
        out = {"params": self.x, "opt": self.opt, "step": t + 1}
        if pipe is not None:
            out["pipeline"] = {"slot": self.slot,
                               "parity": 1 - int(pipe["parity"])}
        return out, metrics


def graph_train_step(step: Callable, state: Dict,
                     batch: Dict) -> GraphedTrainStep:
    """The bus step ``step`` (from ``build_train_step``) replayed from CUDA
    graphs over ``state``'s buffers, which become the static state: every
    later call must pass the state the previous call returned.  ``batch``
    gives the static batch buffers' keys, shapes and dtypes.  Raises for
    the tree path and for a state that is not on a CUDA device."""
    static = getattr(step, "static", None)
    if static is None:
        raise ValueError("graph_train_step captures the packed-bus step; the "
                         "tree path runs eagerly (ROADMAP.md)")
    if state["params"].device.type != "cuda":
        raise ValueError(f"CUDA graphs need the train state on a CUDA "
                         f"device, got {state['params'].device}; the CPU "
                         "runs the eager step")
    return GraphedTrainStep(static, state, batch)
