#!/usr/bin/env python3
"""Run one of ``chip_smoke.py``'s tensor-parallel phases alone with its bf16
run at the config's full depth, four ranks sharing the card, each holding
its share of the whole model.

    python tools/tp_phase.py [--arch qwen3_14b | deepseek_moe_16b |
                              falcon_mamba_7b]
    python tools/tp_phase.py --train

* ``qwen3_14b`` (the default): phase 31 — (a) f32 at 2 layers, (b) bf16 at
  all 40 (the script runs ``chip_smoke.TP_BF16_LAYERS``); each rank holds
  7.38 GB.  First the phase-7 checks of rows 6 and 7 at its rank's heads
  (K 2, G 5, hd 128, f32 and bf16, the bf16 ones timed).
* ``deepseek_moe_16b``: phase 29 (b) — the EP + TP serving layout, bf16
  at all 28 layers (the script runs ``chip_smoke.EP_B_LAYERS``); first
  rows 6 and 7 at its rank's heads (K 4, G 1, hd 128).
* ``falcon_mamba_7b``: phase 32 — (a) f32 at 2 layers, (b) bf16 at all 64
  (the script runs ``chip_smoke.SSM_TP_BF16_LAYERS``); no kernel runs on
  this path.
* ``--train`` (``qwen3_14b``): phase 33, the tree train path
  tensor-parallel on a ``(2, 2)`` grid, at ``TRAIN_LAYERS`` (2, the
  deepest at which the four ranks fit the card when the phase runs
  alone: a rank's EDM peak ~18.3 GiB; the script runs
  ``chip_smoke.TP_TRAIN_LAYERS``), every gate of the phase; then the
  same 3 steps at ``COMPARE_LAYERS`` (1, the deepest at which two whole
  agents fit: ~35 GB a rank) on the ``(2, 2)`` grid and on the ``(2, 1)``
  grid of the tree across ranks (ranks 0–1, one whole agent each), the
  per-agent losses a step and the final parameters (the ``(2, 2)``
  run's gathered over ``model``) held to each other, each leaf's
  difference within ``UPDATE_RTOL`` of its update; a control run on the
  ``(2, 2)`` grid with α halved must read over that limit on every leaf.

Four spawned ranks run the phase's rank function, then the one-process
references (once the ranks have exited), the phase's lines and its
gates.  Prints the seconds of each part.  Needs a CUDA device.
"""
import argparse
import dataclasses
import json
import shutil
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

STORE = ROOT / "build" / "tp_phase"
# the rank function of each arch's phase, at the config's depth
RANK_FN = {"qwen3_14b": "tp_ranks", "deepseek_moe_16b": "ep_b_ranks",
           "falcon_mamba_7b": "ssm_ranks"}
# --train: phase 33's depth alone, and the depth of its (2, 1) comparison
TRAIN_LAYERS, COMPARE_LAYERS = 2, 1
# --train: a leaf of the (2, 2) run after 3 steps may differ from the
# (2, 1) run's by this share of its update ‖x₂₁ − x₀‖.  Sound bf16 runs
# read up to 0.107 (blocks|0|attn|wq: its update is ~2 bf16 ulps of its
# size, so one rounding that parts puts ~1/8 of it between the runs); an
# update half as large (the control: α halved) reads ~0.5
UPDATE_RTOL = 2 ** -2
# the paged kernels' checks at the rank's heads: (decode case, (K, G), the
# timed prefill case)
KERNELS = {"qwen3_14b": ("qwen3_14b_tp", (2, 5), cs.PREFILL_TIMED_TP),
           "deepseek_moe_16b": ("deepseek_moe_16b_tp", (4, 1),
                                cs.PREFILL_TIMED_EP_TP)}


def rank_main(rank: int, world: int, arch: str, n_layers: int,
              train: bool = False) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda", init_method=f"file://{STORE}/store", rank=rank,
                     world_size=world, timeout_s=600)
    rec = {"rank": rank}
    if train:
        cs.tp_train_ranks(rank, world, rec, n_layers)
        train_compare(rank, rec, COMPARE_LAYERS)
    else:
        getattr(cs, RANK_FN[arch])(rank, world, rec, n_layers)
    (STORE / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def _steps(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["agent_losses"].tolist())
    for t in step.transports():
        t.raise_on_timeout()
    return state, losses


def _grid_run(model, run, sched, grid, batches):
    """3 steps on the ``(2, 2)`` grid: the per-agent losses a step and the
    rank's agent's final parameters gathered over ``model``, on the
    host."""
    from repro_torch.core.sharding import gather_params
    from repro_torch.train import build_train_step, init_state, trainer
    step = build_train_step(model, run, sched, use_fused_kernel=True,
                            mesh=grid)
    state, losses = _steps(step, init_state(model, run, cs.TP_TRAIN_AGENTS,
                                            seed=0, mesh=grid), batches)
    x = state["params"]
    del state
    cs.free()
    step.close()
    whole = {p: v.cpu() for p, v in gather_params(
        {p: v[0] for p, v in x.items()}, trainer._leaf_specs(model, run),
        grid).items()}
    del x, step
    cs.free()
    return losses, whole


def train_compare(rank: int, rec: dict, n_layers: int) -> None:
    """The ``(2, 2)`` run against the ``(2, 1)`` tree run across ranks, 3
    steps each at ``n_layers``: the ``(2, 2)`` ranks gather their agent's
    final parameters over ``model``, once as the run is and once from a
    control run with α halved (rank 2, agent 1's, hands both to rank 1,
    which holds agent 1 on the ``(2, 1)`` grid), then ranks 0–1 run the
    ``(2, 1)`` grid and hold their agent's parameters to the gathered
    ones: each leaf's ``‖x₂₂ − x₂₁‖`` and the control's against
    ``‖x₂₁ − x₀‖`` (the update), and the update against ``‖x₂₁‖``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_gossip_mesh
    from repro_torch.models import build_model
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    A = cs.TP_TRAIN_AGENTS
    model = build_model(cs.tp_train_config(n_layers))
    run = cs.tp_train_run()
    batches = cs.tp_train_batches(model.cfg.vocab_size)
    sched = make_gossip_schedule(run, A)
    grid = make_gossip_mesh(A, agents_per_device=1, model=2)
    flat = make_gossip_mesh(A, agents_per_device=1)
    t0 = time.time()
    losses, whole = _grid_run(model, run, sched, grid, batches)
    rec["cmp_layers"], rec["cmp_grid_losses"] = n_layers, losses
    rec["cmp_grid_s"] = time.time() - t0
    _, control = _grid_run(model, dataclasses.replace(
        run, alpha=run.alpha / 2), sched, grid, batches)
    # agent 1's parameters to the rank that holds agent 1 on (2, 1)
    for tree in (whole, control):
        if rank == 2:
            for p in sorted(tree):
                dist.send(tree[p], dst=1)
        elif rank == 1:
            for p in sorted(tree):
                dist.recv(tree[p], src=2)
    dist.barrier()
    if not flat.member:
        return
    t0 = time.time()
    step = build_train_step(model, run, sched, use_fused_kernel=True,
                            mesh=flat)
    state, losses = _steps(step, init_state(model, run, A, seed=0,
                                            mesh=flat), batches)
    rec["cmp_flat_losses"] = losses
    x0 = model.init(torch.Generator(device="cuda").manual_seed(0))
    rel = {}
    for p, v in state["params"].items():
        want = v[0].float()
        upd = (want - x0.pop(p).float()).norm()
        rel[p] = [float((t[p].cuda().float() - want).norm()
                        / upd.clamp_min(1e-30)) for t in (whole, control)]
        rel[p].append(float(upd / want.norm().clamp_min(1e-30)))
        del want, upd
    rec["cmp_rel"] = rel
    rec["cmp_flat_s"] = time.time() - t0
    del state, x0
    cs.free()
    step.close()


def check_compare(ranks) -> None:
    """The ``(2, 1)`` comparison's gates: every step's per-agent losses
    within ``TP_TRAIN_LOSS_RTOL``; each leaf's difference within
    ``UPDATE_RTOL`` of its update; the control (α halved) over that limit
    on every leaf whose update is at least 2⁻⁸ of its size (a smaller
    one may round to the same bf16 values at either α)."""
    import math
    for r in ranks[:2]:
        for t, (a, b) in enumerate(zip(r["cmp_grid_losses"],
                                       r["cmp_flat_losses"])):
            for ga, gb in zip(a, b):
                cs.check(math.isclose(ga, gb,
                                      rel_tol=cs.TP_TRAIN_LOSS_RTOL),
                         f"compare rank {r['rank']} step {t}: losses {a} "
                         f"on (2, 2), {b} on (2, 1)")
        for p, (to_update, control, update) in r["cmp_rel"].items():
            cs.check(to_update <= UPDATE_RTOL,
                     f"compare rank {r['rank']}: {p} off by {to_update:.3e}"
                     f" of its update")
            cs.check(control > UPDATE_RTOL or update < 2 ** -8,
                     f"compare rank {r['rank']}: the control (α halved) "
                     f"reads {control:.3e} of {p}'s update, within the "
                     f"limit {UPDATE_RTOL}")


def print_compare(ranks, smi: str) -> None:
    for r in ranks[:2]:
        rel = r["cmp_rel"]
        worst = max(rel, key=lambda p: rel[p][0])
        gated = [p for p in rel if rel[p][2] >= 2 ** -8]
        least = min(gated, key=lambda p: rel[p][1])
        print(f"[compare] rank {r['rank']} ({r['cmp_layers']} layers, 3 "
              f"steps): losses (2, 2) {r['cmp_grid_losses']} against (2, 1)"
              f" {r['cmp_flat_losses']}; worst leaf {worst}: "
              f"{rel[worst][0]:.3e} of its update (the update "
              f"{rel[worst][2]:.3e} of its size; limit {UPDATE_RTOL}); "
              f"control (α halved): least {least} {rel[least][1]:.3e}, "
              f"median {statistics.median(v[1] for v in rel.values()):.3e}"
              f" of the update, {len(gated)} of {len(rel)} leaves gated; "
              f"(2, 2) {r['cmp_grid_s']:.1f} s, (2, 1) "
              f"{r['cmp_flat_s']:.1f} s; {smi}", flush=True)


def kernel_checks(arch: str) -> None:
    """Rows 6 and 7 at the rank's heads against their plain twins, f32 and
    bf16, the bf16 ones timed."""
    import torch
    name, kg, timed_case = KERNELS[arch]
    case = next(c for c in cs.DECODE_CASES if c["name"] == name)
    prefill = [c for c in cs.PREFILL_CASES if c[4:6] == kg]
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        print(f"[kernels] paged_attention "
              f"{cs.check_decode(case, dt, timed=bf16)}", flush=True)
        for c in prefill + [timed_case]:
            timed = bf16 and c == timed_case
            print(f"[kernels] paged_prefill "
                  f"{cs.check_prefill(c, dt, timed=timed)}", flush=True)
    cs.free()


def references(arch: str, n_layers: int) -> dict:
    if arch == "qwen3_14b":
        return {"tp_refs": cs.tp_references(n_layers)}
    if arch == "deepseek_moe_16b":
        return {"ep_b_one_process": cs.ep_b_reference(n_layers)}
    return {"ssm_refs": cs.ssm_references(n_layers)}


def report(arch: str, ranks, refs, smi: str) -> None:
    """The phase's lines, then its gates."""
    rec = dict(refs, ranks=ranks)
    if arch == "qwen3_14b":
        cs.print_tp(rec, smi)
        cs.check_tp_ranks(ranks, refs["tp_refs"])
    elif arch == "deepseek_moe_16b":
        cs.print_ep_b(rec, smi)
        cs.check_ep_b_ranks(ranks, refs["ep_b_one_process"])
    else:
        cs.print_ssm(rec, smi)
        cs.check_ssm_ranks(ranks, refs["ssm_refs"])


def main() -> None:
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    ap = argparse.ArgumentParser(prog="python tools/tp_phase.py")
    ap.add_argument("--arch", choices=tuple(RANK_FN), default="qwen3_14b")
    ap.add_argument("--train", action="store_true",
                    help="phase 33 (qwen3_14b trained tensor-parallel on a "
                         "(2, 2) grid) and its (2, 1) comparison")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/tp_phase.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    t0 = time.time()
    build.build_all()
    print(f"[build] {time.time() - t0:.1f} s; {smi}", flush=True)
    if args.train:
        train_main(smi, t0)
        return
    n_layers = get_config(args.arch).n_layers
    if args.arch in KERNELS:
        t1 = time.time()
        kernel_checks(args.arch)
        print(f"[time] kernels {time.time() - t1:.1f} s", flush=True)
    shutil.rmtree(STORE, ignore_errors=True)
    STORE.mkdir(parents=True)
    t1 = time.time()
    mp.spawn(rank_main, args=(4, args.arch, n_layers), nprocs=4)
    ranks = [json.loads((STORE / f"rank{r}.json").read_text())
             for r in range(4)]
    print(f"[time] ranks {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    refs = references(args.arch, n_layers)
    print(f"[time] references {time.time() - t1:.1f} s", flush=True)
    report(args.arch, ranks, refs, smi)
    print(f"[done] {args.arch} at {n_layers} bf16 layers, every gate held; "
          f"{time.time() - t0:.1f} s; {smi}", flush=True)


def train_main(smi: str, t0: float) -> None:
    """``--train``: four spawned ranks run phase 33 at ``TRAIN_LAYERS``
    and the comparison at ``COMPARE_LAYERS``; then the gates."""
    import torch.multiprocessing as mp
    shutil.rmtree(STORE, ignore_errors=True)
    STORE.mkdir(parents=True)
    t1 = time.time()
    mp.spawn(rank_main, args=(4, "qwen3_14b", TRAIN_LAYERS, True),
             nprocs=4)
    ranks = [json.loads((STORE / f"rank{r}.json").read_text())
             for r in range(4)]
    print(f"[time] ranks {time.time() - t1:.1f} s", flush=True)
    cs.print_tp_train({"ranks": ranks}, smi)
    print_compare(ranks, smi)
    cs.check_tp_train_ranks(ranks)
    check_compare(ranks)
    print(f"[done] phase 33 at {TRAIN_LAYERS} layers and the (2, 1) "
          f"comparison at {COMPARE_LAYERS}, every gate held; "
          f"{time.time() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
