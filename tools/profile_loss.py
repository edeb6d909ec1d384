#!/usr/bin/env python3
"""Repeat ``chip_smoke.py`` phase 4g's profiled eager steps, with and
without the settle that ends its profiled regions, and count the kernel
records each trace lacks.

    python tools/profile_loss.py [N]

On ``chip_smoke.py``'s main cell (``smollm_360m`` at full width, 4 agents
on one card, ring, fused kernels, seq 128, per-agent batch 1), f32 and
``--wire int8``, N times each (default 6) with the profiled region closed
right after the device drains and N times held open
``chip_smoke.PROFILE_SETTLE_S`` longer, in turns.  Each repeat runs as
phase 4g's eager trajectory does, under deterministic algorithms: the
seed-0 state, ``GRAPH_STEPS`` eager steps, then one more under
``torch.profiler`` (CUDA activity).  For each profiled step it prints

- the device busy ms and the number of device records;
- the port's training kernels in the trace (``chip_smoke.TRACED``) against
  the wrappers' launch counts over the same step (what was launched);
- the launch records (``cudaLaunchKernel`` and kin, taken at the call on
  the host) whose correlation id no device record carries — a kernel
  launched whose record the profiler lost — and where they lie in the
  step's span of launches (0 the first, 1 the last).

The last line is a JSON summary by case.  Needs a CUDA device.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts the repo's src on the path)

LAUNCH_CALLS = ("LaunchKernel", "cuLaunchCooperativeKernel")


def records(prof):
    """(device records, host launch records) of a trace: each a list of
    ``(correlation id, start ns)``."""
    from torch.autograd import DeviceType
    device, launches = [], []
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.correlation_id(), ev.start_ns())
        if ev.device_type() == DeviceType.CUDA:
            device.append(rec)
        elif any(k in ev.name() for k in LAUNCH_CALLS):
            launches.append(rec)
    return device, launches


def one_step(model, run, batches, settle_s: float):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.train import (build_train_step, init_state,
                                   make_gossip_schedule)
    cs.free()
    state = init_state(model, run, cs.AGENTS, seed=0, device="cuda")
    step = build_train_step(model, run, make_gossip_schedule(run, cs.AGENTS),
                            use_fused_kernel=True, device="cuda")
    for b in batches[:-1]:
        state, m = step(state, b)
        {k: float(v) for k, v in m.items()}             # synchronises
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batches[-1])
        torch.cuda.synchronize()
        time.sleep(settle_s)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    rows = cs.device_rows(prof)
    device, launches = records(prof)
    seen = {c for c, _ in device}
    lost = sorted(t for c, t in launches if c not in seen)
    t0 = min((t for _, t in launches), default=0)
    t1 = max((t for _, t in launches), default=0)
    traced = {k: v for k, v in cs.traced_launches(rows).items() if v}
    rec = {"busy_ms": sum(r[0] for r in rows),
           "device_records": len(device),
           "launch_records": len(launches),
           "launches_without_device_record": len(lost),
           "lost_at": [round((t - t0) / max(t1 - t0, 1), 4)
                       for t in lost[:6] + lost[6:][-2:]],
           "traced": traced, "wrapper_launches": counts,
           "training_kernel_missing": traced != counts}
    del state, step, prof
    cs.free()
    return rec


def main(n: int) -> None:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    if not torch.cuda.is_available():
        raise SystemExit("profile_loss.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; {cs.nvidia_smi()}", flush=True)
    model = build_model(get_config(cs.ARCH))
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=cs.SEQ,
                       n_agents=cs.AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(2)
    batches = [data.sample(dgen, 1) for _ in range(cs.GRAPH_STEPS + 1)]
    summary = {}
    torch.use_deterministic_algorithms(True)
    try:
        for wire in ("f32", "int8"):
            run = cs.bus_run(wire=wire)
            for i in range(2 * n):
                settle_s = cs.PROFILE_SETTLE_S if i % 2 else 0.0
                rec = one_step(model, run, batches, settle_s)
                print(f"{wire} settle {settle_s} rep {i // 2}: "
                      f"{json.dumps(rec)}", flush=True)
                case = summary.setdefault(f"{wire} settle {settle_s}", {
                    "busy_ms": [], "lost": [], "lost_in_last_tenth": [],
                    "training_kernel_missing": 0})
                case["busy_ms"].append(round(rec["busy_ms"], 3))
                case["lost"].append(rec["launches_without_device_record"])
                case["lost_in_last_tenth"].append(
                    sum(x > 0.9 for x in rec["lost_at"]))
                case["training_kernel_missing"] += \
                    rec["training_kernel_missing"]
    finally:
        torch.use_deterministic_algorithms(False)
    print(json.dumps(summary))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
