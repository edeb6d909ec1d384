#!/usr/bin/env python3
"""Device time of the port's combine kernels on the full bus.

    python tools/time_combines.py SRC_DIR LABEL [--strided]

``SRC_DIR`` is the ``src`` directory of a checkout of this repository (its
``repro_torch`` package is imported from there, and builds its kernels
into that checkout's ``build/``), ``LABEL`` a tag for the output lines.
On the full ``smollm_360m`` bus of 4 agents, ``(4, 3195392, 128)``, it
times the 3-ary f32 combine, the 3-ary bf16 → f32 combine, the ring
kernel, the table kernel and the 3-ary q8 combine, each the median of 20
CUDA-event pairs queued behind a device-side spin (as ``chip_smoke.py``
times), and prints each kernel's registers from its ``nvcc`` log.

``--strided`` (a checkout whose combines take an agent stride) also
times the ring, table, 3-ary f32 and q8 combines on the rows ``ROWS`` of
the bus in place — the grouped cell's attention group, ``chip_smoke.py``
phase 14 — and the same call on contiguous copies of those rows, in turn
``STRIDED_ROUNDS`` times.

To compare two commits on one card, unpack the other commit into a
git-ignored directory (``git archive <commit> src | tar -x -C
build/parent``) and run both in turns in one command: parent, change,
change, parent.  Needs a CUDA device.
"""
import statistics
import sys

SHAPE = (4, 3195392, 128)
ROWS = (737280, 1352192)
BLOCK_ROWS = 512
REPS = 20
STRIDED_ROUNDS = 3
QUEUE_CYCLES = 20_000_000


def time_ms(torch, fn) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES)
    pairs = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def combines(torch, ops, x, out, gen):
    """The timed calls on bus ``x`` into ``out`` (either may be a row
    range of a larger bus), by name."""
    terms = [(0, 0.5), (1, 0.25), (-1, 0.25)]
    ws = [w for _, w in terms]
    nbrs = [torch.roll(x, 1, 0), torch.roll(x, -1, 0)]
    src = torch.tensor([[0, 1, 2, 3], [3, 0, 1, 2], [1, 2, 3, 0]],
                       dtype=torch.int32, device="cuda")
    w = torch.full((3, 4), 1 / 3, device="cuda")
    q = torch.randint(-127, 128, x.shape, generator=gen, device="cuda",
                      dtype=torch.int8)
    sc = torch.rand((x.shape[0], x.shape[1] // BLOCK_ROWS), generator=gen,
                    device="cuda")
    pays = [(q, sc), (torch.roll(q, 1, 0), torch.roll(sc, 1, 0)),
            (torch.roll(q, -1, 0), torch.roll(sc, -1, 0))]
    return {
        "gossip_axpy f32 3-ary": lambda: ops.gossip_axpy([x] + nbrs, ws,
                                                         out=out),
        "ring_combine": lambda: ops.ring_combine(x, terms, out=out),
        "table_combine": lambda: ops.table_combine(x, src, w, out=out),
        "gossip_axpy_q8 3-ary": lambda: ops.gossip_axpy_wire(
            pays, ws, fmt="int8", block_rows=BLOCK_ROWS, out=out),
    }


def main(src: str, label: str, strided: bool) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import build, ops
    if not torch.cuda.is_available():
        raise SystemExit("time_combines.py needs a CUDA device")
    dev = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda")
    out = torch.empty_like(x)
    cases = combines(torch, ops, x, out, gen)
    rolled_bf16 = [t.to(torch.bfloat16) for t in
                   (x, torch.roll(x, 1, 0), torch.roll(x, -1, 0))]
    cases["gossip_axpy bf16->f32 3-ary"] = lambda: ops.gossip_axpy(
        rolled_bf16, [0.5, 0.25, 0.25], out_dtype=torch.float32, out=out)
    for name, fn in cases.items():
        print(f"{label} {name}: {time_ms(torch, fn):.4f} ms ({dev})",
              flush=True)
    del cases, rolled_bf16
    torch.cuda.empty_cache()
    if strided:
        r0, r1 = ROWS
        xs, os_ = x[:, r0:r1], out[:, r0:r1]
        xc = xs.contiguous()
        oc = torch.empty_like(xc)
        in_place = combines(torch, ops, xs, os_, gen)
        copies = combines(torch, ops, xc, oc, gen)
        for rnd in range(STRIDED_ROUNDS):
            for name in in_place:
                s = time_ms(torch, in_place[name])
                c = time_ms(torch, copies[name])
                print(f"{label} round {rnd} {name} on rows [{r0}, {r1}): "
                      f"in place {s:.4f} ms, contiguous copy {c:.4f} ms "
                      f"({dev})", flush=True)
    for name in ("gossip_axpy", "ring_combine", "table_combine",
                 "gossip_axpy_q8"):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"{label} {name} build: {line.strip()}")


if __name__ == "__main__":
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(pos) != 2 or set(flags) - {"--strided"}:
        raise SystemExit(__doc__)
    main(pos[0], pos[1], "--strided" in flags)
