"""Training launcher of the port: ``python -m repro_torch.launch.train``.

Runs the decentralized trainer with every agent on one GPU, taking the
reference launcher's flags plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path and must be asked for):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \
      --steps 5 --agents 4 --agents-per-device 4 --gossip-engine ppermute \
      --fused-kernel --seq 128

``--algorithm`` takes every name of ``ALGORITHMS`` (edm, ed, edm_ef,
dsgd, dmsgd, dsgt, dsgt_hb, decentlam, qg); every algorithm but EDM, and
EDM with ``--no-packed-bus``, trains on the tree path (one EDM and one
combine launch per parameter leaf with ``--fused-kernel``).
``--wire {bf16,int8}`` runs the error-feedback compressed gossip wire
and ``--gossip-schedule {round_robin,alt_hier}`` (with
``--gossip-period`` / ``--gossip-seed``) the time-varying schedules; the
header line prints the schedule, its period-product λ, the wire format
and, on the bus, the modeled wire bytes of one gossip round.

``--churn PLAN`` (a path or inline JSON
:class:`~repro_torch.core.elastic.DropPlan`) gossips over the schedule
degraded per liveness epoch (the header's schedule reads
``elastic(...)``, ``λ_prod`` is the worst epoch's, and one line per epoch
gives its survivors, λ and modeled wire bytes);
``--overlap delayed`` runs the overlapped gossip pipeline (header
``+overlap``), with or without ``--wire``.
``--gossip-groups SPEC`` (a JSON list of group specs, or ``@file.json``)
lays the bus out in policy groups, each gossiping on its own cadence,
schedule and wire (DESIGN §12): the header's ``wire_bytes/step`` is the
first step's total and ``groups=`` lists each group's name, rows and
policy; one line per group gives its modeled wire bytes on a gossiping
step and how many of the run's steps gossip.  The ``moe[:k]`` preset
puts an MoE model's expert weights in their own group, the ``ssm[:k]``
preset an SSM model's conv / state leaves (``--arch falcon_mamba_7b``;
``ssm:0,moe`` makes both groups on the hybrid ``jamba_1_5_large_398b``);
k is the group's cadence, 0 by default: they stay local.

``--ckpt PATH`` writes the full train state after the last step
(:func:`repro_torch.train.checkpoint.save_state`: the logical npz of the
JAX package, bus unpacked to leaves, the pipeline as its live payload)
and ``--resume PATH`` restores one before the first step
(:func:`~repro_torch.train.checkpoint.load_state_resized`: a file of
either package, at any agent count: survivors restore bit for bit,
joining agents take the consensus mean with ψ := x).  The token stream
(and the frontend embeddings of a VLM, ``--arch pixtral_12b``, or the
encoder's frames of ``--arch whisper_small``) is drawn per global step,
so a run resumed at step t takes the batches the uninterrupted run takes
from step t on.

Across ranks (one process per rank, under ``torchrun``): ``--gossip-engine
ppermute`` with ``--agents-per-device B`` below ``--agents A`` spreads the
agents over A / B ranks, and ``--agents pod --pods P --shards S`` runs P
agents, each over a pod of S row shards (the shard-resident mode)::

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm_360m --smoke --agents 4 --agents-per-device 1 \
      --gossip-engine ppermute --fused-kernel --steps 2 --device cpu
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch smollm_360m --smoke --agents pod --pods 2 --shards 2 \
      --gossip-engine ppermute --steps 2 --device cpu

(``python -m torch.distributed.run`` is the same launcher.)  gloo on the
CPU, NCCL on cards; ranks that share one card (more ranks than cards)
gossip only through the peer-pointer ring kernel (``--topology ring
--fused-kernel``).  Rank 0 prints; the header names the rank grid and says
when ranks share a card.  ``--ckpt`` gathers the state to rank 0, which
writes the one-process file; ``--resume`` gives every rank its block of a
file of either package.  The multi-rank step is eager.

On a CUDA device the bus path runs as CUDA graphs
(:func:`repro_torch.train.graphs.graph_train_step`: the first step of each
schedule round runs eagerly and is captured, later ones replay);
``--eager`` keeps the eager step, the oracle and the debugging path.  The
tree path and CPU runs are eager.  The header line says which runs.
``--topology ring --gossip-engine ppermute --agents-per-device A
--fused-kernel`` gossips the bus through the ring kernel (the rolls fused
into the combine).  The result's ``graph_replays`` counts the steps that
replayed a graph (0 when eager) and ``graphs`` the graphs captured.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.schedule import (group_wire_bytes_per_step,
                                       wire_bytes_per_step)
from repro_torch.core.wire import make_codec
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.flags import add_run_flags, run_config_overrides
from repro_torch.launch.mesh import init_distributed, make_gossip_mesh
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, bus_layout_for, checkpoint,
                               init_state, make_gossip_schedule,
                               resolve_features)
from repro_torch.train.graphs import graph_train_step

__all__ = ["parser", "main"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--agents", default="4",
                    help="agent count, or 'pod': --pods agents, each over "
                         "--shards row shards (one rank each)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--per-agent-batch", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1,
                    help="pod count for torus/hier topologies")
    ap.add_argument("--shards", type=int, default=0,
                    help="--agents pod: row shards an agent (default: the "
                         "world size / --pods)")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="CUDA kernels for the EDM update and the gossip "
                         "combine")
    add_run_flags(ap)
    ap.add_argument("--phi", type=float, default=0.2,
                    help="Dirichlet heterogeneity of the token streams")
    ap.add_argument("--ckpt", default="",
                    help="write the train state here after the last step")
    ap.add_argument("--churn", default="",
                    help="DropPlan (path or inline JSON): gossip over the "
                         "schedule degraded per liveness epoch, re-checked "
                         "against Assumption 1 per epoch")
    ap.add_argument("--resume", default="",
                    help="restore a train state saved by --ckpt (either "
                         "package; another agent count is resized)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--eager", action="store_true",
                    help="run the bus step eagerly on the card instead of "
                         "replaying it from CUDA graphs")
    return ap


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    """Parse ``argv``, train, print one line per logged step, and return
    ``{"state", "metrics", "step_seconds", "run", "wire_bytes", "epochs",
    "groups", "graph_replays", "graphs"}`` — the final train state,
    per-step metrics as floats, per-step wall times (each step ends in a
    device synchronisation), the modeled wire bytes of one gossip round
    ``[as configured, one agent per device]`` on the bus (None on the tree
    path; on a grouped bus the first step's total), under ``--churn``
    each liveness epoch's start, survivors, λ and wire bytes (else None),
    and on a grouped bus each group's name, rows, policy, modeled wire
    bytes on a gossiping step and gossiping steps of the run (else
    None)."""
    args = parser().parse_args(argv)
    pod = args.agents == "pod"
    if args.shards and not pod:
        raise ValueError("--shards goes with --agents pod")
    n_agents = args.pods if pod else int(args.agents)
    ranked = pod or (args.gossip_engine == "ppermute"
                     and args.agents_per_device < n_agents)
    mesh = shard_axes = None
    say = print
    owned = False
    if ranked:
        if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
            raise ValueError(
                f"{'--agents pod' if pod else '--agents-per-device < --agents'}"
                " runs one process per rank: launch it under torchrun "
                "--standalone --nproc-per-node M (M ranks)")
        if args.gossip_engine != "ppermute":
            raise ValueError("--agents pod rides the shard-resident ppermute "
                             "path (set --gossip-engine ppermute)")
        owned = not dist.is_initialized()
        device = init_distributed(args.device or "cuda")
        shards = (args.shards or max(dist.get_world_size() // n_agents, 1)
                  if pod else 1)
        mesh = make_gossip_mesh(
            n_agents, pods=n_agents if pod else args.pods,
            agents_per_device=1 if pod else args.agents_per_device,
            shards=shards, device=device)
        shard_axes = "data" if pod else None
        if not mesh.member:
            raise ValueError(f"rank {mesh.rank} is outside the {mesh.shape} "
                             f"grid: run {mesh.size} ranks")
        if mesh.rank:
            say = lambda *a, **k: None  # noqa: E731
    else:
        device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    run = RunConfig(global_batch=n_agents * args.per_agent_batch,
                    seq_len=args.seq, agents="pod" if pod else "data",
                    remat=False, **run_config_overrides(args))
    feats = resolve_features(run)
    sched = make_gossip_schedule(run, n_agents,
                                 pods=1 if pod else args.pods,
                                 churn=args.churn or None)
    wire_bytes, layout, groups, group_bytes = None, None, None, None

    def round_bytes(step: int):
        # modeled bytes of one gossip round as configured (0 with every
        # agent on one device) and with one agent per device, as across
        # GPUs; on a grouped bus the groups' total at this step
        if group_bytes is not None:
            return [group_bytes(step, b)["total"]
                    for b in (args.agents_per_device, 1)]
        return [wire_bytes_per_step(
            sched, step, elems_per_agent=layout.padded_elems,
            agents_per_device=b, engine=args.gossip_engine, codec=codec)
            for b in (args.agents_per_device, 1)]

    if feats.packed_bus:
        layout = bus_layout_for(model, n_agents, feats.groups,
                                mesh.shards if mesh is not None else 1)
        codec = make_codec(feats.wire, layout.block_rows)
    step = build_train_step(model, run, sched,
                            use_fused_kernel=args.fused_kernel,
                            pods=1 if pod else args.pods, device=device,
                            mesh=mesh, shard_axes=shard_axes)
    if step.group_plans is not None:
        plans = step.group_plans
        scheds = {p.group.name: p.sched for p in plans if p.sched}
        codecs = {p.group.name: p.wire for p in plans if p.wire}

        def group_bytes(t: int, b: int) -> dict:
            return group_wire_bytes_per_step(
                layout.groups, scheds, t, agents_per_device=b,
                engine=args.gossip_engine, codecs=codecs)

        # a group of cadence k gossips on the steps t with t % k == k − 1:
        # its bytes on the first of them (one agent per device), and how
        # many of the run's steps they are
        groups = [{"name": g.name, "rows": g.rows,
                   "gossip_every": g.gossip_every, "wire": g.wire,
                   "schedule": scheds[g.name].name if g.name in scheds
                   else "-",
                   "wire_bytes": (group_bytes(g.gossip_every - 1, 1)[g.name]
                                  if g.name in scheds else 0),
                   "gossip_steps": (args.steps // g.gossip_every
                                    if g.name in scheds else 0)}
                  for g in layout.groups]
    if layout is not None:
        wire_bytes = round_bytes(0)
    bytes_str = ("" if wire_bytes is None else
                 f" wire_bytes/step={wire_bytes[0]} (one agent per device: "
                 f"{wire_bytes[1]})")
    graphed = (feats.packed_bus and device.type == "cuda"
               and not args.eager and mesh is None)
    mode = ("cuda-graph" if graphed else "eager (--eager)" if args.eager
            else "eager (CPU)" if device.type != "cuda"
            else "eager (ranks)" if mesh is not None
            else "eager (tree path)")
    grid_str = ""
    if mesh is not None:
        grid_str = (f" ranks={mesh.size} grid={mesh.shape} "
                    f"axes={','.join(mesh.axis_names)} "
                    f"agents_per_rank={mesh.agents_per_device} "
                    f"shards={mesh.shards} backend={mesh.backend}"
                    + (f" (ranks share {device})" if mesh.shared else ""))
    # --topology only feeds the static schedule; don't print it otherwise
    topo_str = (f"topo={args.topology} " if args.gossip_schedule == "static"
                else "")
    n_params = sum(t.numel() for t in model.meta().values())
    say(f"arch={cfg.name} ({n_params/1e6:.1f}M params) "
          f"agents={n_agents}{f'x{mesh.shards}shards' if pod else ''} "
          f"{topo_str}schedule={sched.name} "
          f"period={sched.period} "
          f"λ_prod={sched.product_spectral_stats()['lambda']:.4f} "
          f"alg={args.algorithm} engine={args.gossip_engine}"
          f"{' +fused' if args.fused_kernel else ''}"
          f"{' +bus' if feats.packed_bus else ' +tree'}"
          f"{' +overlap' if feats.overlap else ''} wire={feats.wire}"
          f"{bytes_str} device={device} step={mode}{grid_str}"
          + ("" if groups is None else " groups=" + ",".join(
              f"{g['name']}:{g['rows']}r/k{g['gossip_every']}/{g['wire']}"
              f"/{g['schedule']}" for g in groups)), flush=True)
    for g in groups or ():
        say(f"group {g['name']}: rows {g['rows']} gossip_every "
              f"{g['gossip_every']} wire {g['wire']} schedule "
              f"{g['schedule']}: wire_bytes on a gossiping step "
              f"{g['wire_bytes']} (one agent per device), "
              f"{g['gossip_steps']} of {args.steps} steps gossip",
              flush=True)
    epochs = None
    if args.churn:
        epochs = sched.epoch_stats()
        for ep in epochs:
            if feats.packed_bus:
                ep["wire_bytes"] = round_bytes(ep["start"])
            say(f"epoch {ep['epoch']} @ step {ep['start']}: "
                  f"{ep['alive']}/{n_agents} alive λ={ep['lambda']:.4f}"
                  + (f" wire_bytes/step={ep['wire_bytes'][0]} (one agent "
                     f"per device: {ep['wire_bytes'][1]})"
                     if feats.packed_bus else ""), flush=True)

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                       n_agents=n_agents, phi=args.phi)
    state = init_state(model, run, n_agents, seed=0, device=device,
                       mesh=mesh, shard_axes=shard_axes)
    if args.resume and mesh is not None:
        state = checkpoint.load_state_ranks(args.resume, state, layout, mesh,
                                            n_agents, shard_axes)
        say(f"resumed <- {args.resume} @ step {state['step']}")
    elif args.resume:
        state = checkpoint.load_state_resized(args.resume, state,
                                              layout=layout)
        print(f"resumed <- {args.resume} @ step {state['step']}")
    gen = torch.Generator(device=device).manual_seed(1)

    def sample() -> Dict[str, torch.Tensor]:
        # one global step's batch; a VLM's frontend embeddings (an
        # encoder-decoder's frames) are drawn right after its tokens from
        # the same generator
        b = data.sample(gen, args.per_agent_batch)
        if cfg.family in ("vlm", "encdec"):
            b["frontend"] = torch.randn(
                (n_agents, args.per_agent_batch, cfg.n_frontend_tokens,
                 cfg.d_model), generator=gen, device=device).to(
                     getattr(torch, cfg.dtype))
        return b

    for _ in range(state["step"]):       # the batches of the steps taken
        sample()
    history, seconds = [], []
    t0 = time.time()
    for t in range(args.steps):
        batch = sample()
        if graphed and t == 0:
            step = graph_train_step(step, state, batch)
        ts = time.perf_counter()
        state, m = step(state, batch)
        # to the host: synchronises the device (agent_losses: a list)
        m = {k: v.tolist() if v.dim() else float(v) for k, v in m.items()}
        seconds.append(time.perf_counter() - ts)
        history.append(m)
        if t % 5 == 0 or t == args.steps - 1:
            say(f"step {t:4d} loss={m['loss']:.4f} "
                  f"consensus={m['consensus']:.2e} "
                  f"({time.time()-t0:.1f}s)", flush=True)
    if args.ckpt and mesh is not None:
        checkpoint.save_state_ranks(args.ckpt, state, layout, mesh, n_agents)
        say(f"checkpoint -> {args.ckpt}")
    elif args.ckpt:
        checkpoint.save_state(args.ckpt, state, layout=layout)
        print(f"checkpoint -> {args.ckpt}")
    if graphed:
        print(f"graphs captured: {len(step.graphs)} (replays "
              f"{step.replays})", flush=True)
    if owned:
        dist.barrier()
        dist.destroy_process_group()
    return {"state": state, "metrics": history, "step_seconds": seconds,
            "run": run, "wire_bytes": wire_bytes, "epochs": epochs,
            "groups": groups, "graph_replays": getattr(step, "replays", 0),
            "graphs": len(getattr(step, "graphs", ())), "mesh": mesh}


if __name__ == "__main__":
    main()
