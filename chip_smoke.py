#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and ``nvidia-smi`` name and power limit; no CUDA
   device is an error;
2. build: compiles the port's CUDA kernels from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` (one ``nvcc`` per
   source, in parallel);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at small odd ones, bit for bit, with its
   median time over 20 launches (CUDA events), the plain version's time
   and the bound (bytes moved at 3.35 TB/s, or f32 operations at
   67 TFLOP/s, whichever is larger);
4. main path: ``repro_torch.launch.train`` — smollm_360m at full width,
   4 agents on one device, ring, packed bus, fused kernels, seq 128,
   5 steps — with the kernels' launch counts reset just before and read
   just after; losses, consensus and grad norms must be finite;
5. profile: one more train step under ``torch.profiler``, the device time
   by kernel;
6. fused against plain: from one saved state and one gradient bus, one
   optimizer + gossip step with the kernels and one with the plain
   versions; the three buses must be bit-equal.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

ARCH, AGENTS, SEQ, STEPS = "smollm_360m", 4, 128, 5
ALPHA, BETA = 0.2, 0.9
MAIN_ARGS = ["--arch", ARCH, "--agents", str(AGENTS), "--agents-per-device",
             str(AGENTS), "--gossip-engine", "ppermute", "--topology", "ring",
             "--fused-kernel", "--seq", str(SEQ), "--per-agent-batch", "1",
             "--steps", str(STEPS), "--alpha", str(ALPHA), "--beta",
             str(BETA), "--device", "cuda"]
REPS = 20


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want):
    """(bit-equal, max |got − want|), one agent row block at a time."""
    equal, err = True, 0.0
    for g, w in zip(got, want):
        equal &= bool(g.dtype == w.dtype and g.shape == w.shape
                      and bool((g == w).all()))
        err = max(err, float((g.float() - w.float()).abs().max()))
    return equal, err


def free():
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_edm(shape, gen, timed: bool):
    import torch
    from repro_torch.kernels import ops, ref
    x, g, m, psi = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(4))
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA)
    equal, err = True, 0.0
    for a in range(shape[0]):
        want = ref.edm_update_ref(x[a], g[a], m[a], psi[a], alpha=ALPHA,
                                  beta=BETA)
        eq, e = compare([o[a] for o in got], want)
        equal, err = equal and eq, max(err, e)
    # in place: m' over m, ψ' over ψ
    m2, p2 = m.clone(), psi.clone()
    inplace = ops.edm_update_bus(x, g, m2, p2, alpha=ALPHA, beta=BETA,
                                 out=(m2, p2, None))
    check(inplace[0].data_ptr() == m2.data_ptr(), "in-place m' not in m")
    eq, e = compare(inplace, got)
    equal, err = equal and eq, max(err, e)
    del m2, p2, inplace
    check(equal, f"edm_update differs from its plain version at {shape}: "
                 f"max abs err {err}")
    rec = {"shape": list(shape), "bit_equal": equal, "max_abs_err": err}
    if timed:
        n = x.numel()
        rec["ms"] = time_ms(lambda: ops.edm_update_bus(
            x, g, m, psi, alpha=ALPHA, beta=BETA, out=got))
        del got
        free()
        rec["plain_ms"] = time_ms(lambda: ref.edm_update_ref(
            x, g, m, psi, alpha=ALPHA, beta=BETA))
        rec["bytes"] = 28 * n                  # 4 f32 reads + 3 f32 writes
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], 7 * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del x, g, m, psi
    free()
    return rec


def check_axpy(shape, n_ops, dtype, out_dtype, gen, timed: bool, ring=False):
    import torch
    from repro_torch.kernels import ops, ref
    if ring:
        # the main path's operands: φ and its two ring neighbours
        phi = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        operands = [phi, torch.roll(phi, 1, 0), torch.roll(phi, -1, 0)]
        weights = [0.5, 0.25, 0.25]
    else:
        operands = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for _ in range(n_ops)]
        weights = [1.0 / (k + 3) for k in range(n_ops)]
    got = ops.gossip_axpy(operands, weights, out_dtype=out_dtype)
    equal, err = True, 0.0
    for a in range(shape[0]):
        want = ref.gossip_axpy_ref([o[a] for o in operands], weights,
                                   out_dtype=out_dtype)
        eq, e = compare([got[a]], [want])
        equal, err = equal and eq, max(err, e)
    name = (f"{len(operands)}-ary {str(dtype)[6:]}→"
            f"{str(out_dtype or dtype)[6:]}")
    check(equal, f"gossip_axpy {name} differs from its plain version at "
                 f"{shape}: max abs err {err}")
    rec = {"case": name, "shape": list(shape), "bit_equal": equal,
           "max_abs_err": err}
    if timed:
        del got
        free()
        n = operands[0].numel()
        in_b = operands[0].element_size()
        out_b = torch.empty((), dtype=out_dtype or dtype).element_size()
        rec["ms"] = time_ms(lambda: ops.gossip_axpy(operands, weights,
                                                    out_dtype=out_dtype))
        rec["plain_ms"] = time_ms(lambda: ref.gossip_axpy_ref(
            operands, weights, out_dtype=out_dtype))
        rec["bytes"] = (len(operands) * in_b + out_b) * n
        rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"],
                                                    2 * len(operands) * n)
        rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    del operands
    free()
    return rec


# ---------------------------------------------------------------------------
# phase 6: one fused optimizer + gossip step against its plain twin
# ---------------------------------------------------------------------------

def fused_vs_plain(model, layout, state, tokens):
    import torch
    from repro_torch.core import build_mixer, make_edm_bus, ring
    from repro_torch.train import losses_and_grads

    x, m, psi = state["params"], state["opt"]["m"], state["opt"]["psi"]
    _, g = losses_and_grads(model, layout, x, tokens)

    def opt(fused):
        mix = build_mixer(ring(AGENTS), mode="static", engine="ppermute",
                          agents_per_device=AGENTS, use_fused_kernel=fused)
        return make_edm_bus(ALPHA, BETA, mix, use_fused_kernel=fused)

    with torch.no_grad():
        x_f, st = opt(True).step(x, g, {"m": m.clone(), "psi": psi.clone()})
        fused = [x_f.cpu(), st["m"].cpu(), st["psi"].cpu()]   # host copies
        del x_f, st
        free()
        x_p, st = opt(False).step(x, g, {"m": m, "psi": psi})
        equal, err = True, 0.0
        for host, dev in zip(fused, (x_p, st["m"], st["psi"])):
            eq, e = compare(host.cuda(), dev)
            equal, err = equal and eq, max(err, e)
    check(equal, f"fused step differs from the plain step: max abs err {err}")
    return {"bit_equal": equal, "max_abs_err": err,
            "shape": list(x.shape)}


# device-time buckets of one train step, by kernel-name substring
BUCKETS = (("edm_update kernel", ("edm_update_kernel",)),
           ("gossip_axpy kernel", ("gossip_axpy_kernel",)),
           ("roll (gossip terms)", ("roll_cuda_kernel",)),
           ("matmul", ("gemm", "cutlass", "sm90_", "nvjet", "cublas")),
           ("copy / cast (bus pack, unpack)", ("copy",)),
           ("reduce (norms, softmax, loss, metrics)", ("reduce", "softmax",
                                                       "logsumexp")))


def profile_step(model, run, state, batch):
    """One fused train step under torch.profiler: device time by kernel
    (kernel events only, so nothing is counted twice) and by bucket."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ring
    from repro_torch.train import build_train_step

    step = build_train_step(model, run, ring(AGENTS), use_fused_kernel=True,
                            device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = [(ev.self_device_time_total / 1e3, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    buckets = {name: 0.0 for name, _ in BUCKETS}
    buckets["other elementwise"] = 0.0
    launches = 0
    for ms, count, key in rows:
        launches += count
        name = next((n for n, keys in BUCKETS
                     if any(k in key for k in keys)), "other elementwise")
        buckets[name] += ms
    return state, {"device_busy_ms": sum(r[0] for r in rows),
                   "kernel_launches": launches, "buckets": buckets,
                   "top": rows[:12]}


def main() -> None:
    t_start = time.time()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is "
                         "available")
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build, ops
    from repro_torch.launch import train as cli
    from repro_torch.models import build_model
    from repro_torch.train import bus_layout_for

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.time()
    libs = build.build_all()
    print(f"[build] {time.time() - t0:.2f} s", flush=True)
    for name, path in libs.items():
        print(f"[build] {name}: {path.relative_to(ROOT)}")
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # 3. kernels against their plain versions, on the card
    model = build_model(get_config(ARCH))
    layout = bus_layout_for(model, AGENTS)
    bus_shape = (AGENTS, layout.rows, 128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    edm_main = check_edm(bus_shape, gen, timed=True)
    edm_small = [check_edm(s, gen, timed=False)
                 for s in ((3, 24, 128), (1, 8, 128), (4, 2048, 128))]
    axpy_main = check_axpy(bus_shape, 3, torch.float32, None, gen,
                           timed=True, ring=True)
    axpy_small = [check_axpy(s, n, dt, odt, gen, timed=False)
                  for s in ((3, 24, 128), (4, 2048, 128))
                  for n in (1, 3, 5)
                  for dt, odt in ((torch.float32, None),
                                  (torch.bfloat16, None),
                                  (torch.bfloat16, torch.float32))]
    for rec in [edm_main, *edm_small]:
        print(f"[kernels] edm_update {rec}", flush=True)
    for rec in [axpy_main, *axpy_small]:
        print(f"[kernels] gossip_axpy {rec}", flush=True)

    # 4. the main path, through the CLI's entry point
    free()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    result = cli.main(MAIN_ARGS)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[main] launches {counts}; peak memory {peak / 2**30:.2f} GiB; "
          f"bus {bus_shape} f32 = {math.prod(bus_shape) * 4 / 1e9:.2f} GB",
          flush=True)
    for t, (m, s) in enumerate(zip(result["metrics"], result["step_seconds"])):
        print(f"[main] step {t} loss={m['loss']:.6f} "
              f"consensus={m['consensus']:.6e} grad_norm={m['grad_norm']:.4f}"
              f" step_s={s:.4f}")
        check(all(math.isfinite(v) for v in m.values()),
              f"non-finite metrics at step {t}: {m}")
    step_s = statistics.median(result["step_seconds"])
    print(f"[main] median step {step_s * 1e3:.1f} ms over {STEPS} steps",
          flush=True)
    check(counts == {"edm_update": STEPS, "gossip_axpy": STEPS},
          f"main path launched {counts}, expected {STEPS} of each kernel")
    state = result["state"]
    check(state["step"] == STEPS, "main path did not take every step")
    check(bool(torch.isfinite(state["params"]).all()), "non-finite x")

    # 5. where one step's device time goes
    data = SyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                       n_agents=AGENTS, phi=0.2)
    dgen = torch.Generator(device="cuda").manual_seed(2)
    state, prof = profile_step(model, result["run"], state,
                               data.sample(dgen, 1))
    busy = prof["device_busy_ms"]
    print(f"[profile] one step: device busy {busy:.3f} ms in "
          f"{prof['kernel_launches']} kernel launches; against the "
          f"unprofiled median step of {step_s * 1e3:.1f} ms the device is "
          f"idle {1 - busy / (step_s * 1e3):.1%} of the step", flush=True)
    for name, ms in prof["buckets"].items():
        print(f"[profile]   {ms:9.3f} ms  {name}")
    for ms, count, key in prof["top"]:
        print(f"[profile]   top {ms:9.3f} ms  x{count:<5d} {key[:80]}")
    del result

    # 6. fused step against plain step, full size, same state and grads
    free()
    twin = fused_vs_plain(model, layout, state,
                          data.sample(dgen, 1)["tokens"])
    print(f"[fused-vs-plain] {twin}", flush=True)
    del state
    free()

    kernels = [
        {"name": "edm_update", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/edm_update.cu",
         "replaces": "src/repro/kernels/edm_update.py:67",
         "launches": counts["edm_update"],
         "max_abs_err": edm_main["max_abs_err"], "ms": edm_main["ms"],
         "plain_ms": edm_main["plain_ms"], "bound_ms": edm_main["bound_ms"],
         "bound_by": edm_main["bound_by"], "library_ms": None,
         "bit_equal": all(r["bit_equal"] for r in [edm_main, *edm_small]),
         "shape": edm_main["shape"], "gb_per_s": edm_main["gb_per_s"]},
        {"name": "gossip_axpy", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip_axpy.cu",
         "replaces": "src/repro/kernels/edm_update.py:187",
         "launches": counts["gossip_axpy"],
         "max_abs_err": axpy_main["max_abs_err"], "ms": axpy_main["ms"],
         "plain_ms": axpy_main["plain_ms"], "bound_ms": axpy_main["bound_ms"],
         "bound_by": axpy_main["bound_by"], "library_ms": None,
         "bit_equal": all(r["bit_equal"] for r in [axpy_main, *axpy_small]),
         "shape": axpy_main["shape"], "gb_per_s": axpy_main["gb_per_s"]},
    ]
    print(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
