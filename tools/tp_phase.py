#!/usr/bin/env python3
"""Run one of ``chip_smoke.py``'s tensor-parallel phases alone with its bf16
run at the config's full depth, four ranks sharing the card, each holding
its share of the whole model.

    python tools/tp_phase.py [--arch qwen3_14b | deepseek_moe_16b |
                              falcon_mamba_7b]

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

Four spawned ranks run the phase's rank function, then the one-process
references (once the ranks have exited), the phase's lines and its
gates.  Prints the seconds of each part.  Needs a CUDA device.
"""
import argparse
import json
import shutil
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
# the paged kernels' checks at the rank's heads: (decode case, (K, G), the
# timed prefill case)
KERNELS = {"qwen3_14b": ("qwen3_14b_tp", (2, 5), cs.PREFILL_TIMED_TP),
           "deepseek_moe_16b": ("deepseek_moe_16b_tp", (4, 1),
                                cs.PREFILL_TIMED_EP_TP)}


def rank_main(rank: int, world: int, arch: str, n_layers: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda", init_method=f"file://{STORE}/store", rank=rank,
                     world_size=world, timeout_s=600)
    rec = {"rank": rank}
    getattr(cs, RANK_FN[arch])(rank, world, rec, n_layers)
    (STORE / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/tp_phase.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_layers = get_config(args.arch).n_layers
    smi = cs.nvidia_smi()
    t0 = time.time()
    build.build_all()
    print(f"[build] {time.time() - t0:.1f} s; {smi}", flush=True)
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


if __name__ == "__main__":
    main()
