#!/usr/bin/env python3
"""Run ``chip_smoke.py`` phase 31 alone with its bf16 run at full depth:
``qwen3_14b`` tensor-parallel over four ranks sharing the card, each rank
holding its 7.38 GB share of the whole 40-layer model.

    python tools/tp_phase.py

First the phase-7 checks of rows 6 and 7 at a TP rank's heads (K 2, G 5,
hd 128: the paged decode case ``qwen3_14b_tp`` and the paged prefill
cases at K 2, G 5 in f32 and bf16, the bf16 ones timed), then four
spawned ranks run ``chip_smoke.tp_ranks`` — (a) f32 at 2 layers, (b)
bf16 at the config's 40 layers (the script itself runs
``chip_smoke.TP_BF16_LAYERS``) — then the one-process references
(``tp_references``), the phase's lines (``print_tp``) and its gates
(``check_tp_ranks``).  Prints the seconds of each part.  Needs a CUDA
device.
"""
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

STORE = ROOT / "build" / "tp_phase"


def rank_main(rank: int, world: int, n_layers: int) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda", init_method=f"file://{STORE}/store", rank=rank,
                     world_size=world, timeout_s=600)
    rec = {"rank": rank}
    cs.tp_ranks(rank, world, rec, n_layers)
    (STORE / f"rank{rank}.json").write_text(json.dumps(rec))
    dist.destroy_process_group()


def main() -> None:
    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("tools/tp_phase.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    n_layers = get_config(cs.TP_ARCH).n_layers
    smi = cs.nvidia_smi()
    t0 = time.time()
    build.build_all()
    print(f"[build] {time.time() - t0:.1f} s; {smi}", flush=True)
    t1 = time.time()
    case = next(c for c in cs.DECODE_CASES if c["name"] == "qwen3_14b_tp")
    prefill = [c for c in cs.PREFILL_CASES if c[4:6] == (2, 5)]
    for dt in (torch.float32, torch.bfloat16):
        bf16 = dt == torch.bfloat16
        print(f"[kernels] paged_attention "
              f"{cs.check_decode(case, dt, timed=bf16)}", flush=True)
        for c in prefill + [cs.PREFILL_TIMED_TP]:
            timed = bf16 and c == cs.PREFILL_TIMED_TP
            print(f"[kernels] paged_prefill "
                  f"{cs.check_prefill(c, dt, timed=timed)}", flush=True)
    cs.free()
    print(f"[time] kernels {time.time() - t1:.1f} s", flush=True)
    shutil.rmtree(STORE, ignore_errors=True)
    STORE.mkdir(parents=True)
    t1 = time.time()
    mp.spawn(rank_main, args=(4, n_layers), nprocs=4)
    ranks = [json.loads((STORE / f"rank{r}.json").read_text())
             for r in range(4)]
    print(f"[time] ranks {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    refs = cs.tp_references(n_layers)
    print(f"[time] references {time.time() - t1:.1f} s", flush=True)
    cs.print_tp({"ranks": ranks, "tp_refs": refs}, smi)
    cs.check_tp_ranks(ranks, refs)
    print(f"[done] phase 31 at {n_layers} bf16 layers, every gate held; "
          f"{time.time() - t0:.1f} s; {smi}", flush=True)


if __name__ == "__main__":
    main()
