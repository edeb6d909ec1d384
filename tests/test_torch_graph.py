"""The bus train step over a static state — what ``graph_train_step``
captures on the card — against today's functional step, on the CPU.

The static step writes x', m', ψ' (and e') over the state's own buffers
(a fused combine writes the new x into x's buffer, any other mix is
copied there) and reads the ``warmup_cosine`` scale from a device scalar
instead of the host.  Run eagerly on the CPU for 3 steps from one state
and one token stream, it must give the functional step's metrics and
state bit for bit, on: the static ring (the ring transport),
``round_robin`` on the exp graph (two rounds: the one-hop round runs the
ring, the two-hop round rolls), ``gossip_every 2`` (steps that skip the
gossip), ``warmup_cosine``, the int8 wire, and the static exp graph (the
rolls and the fused combine).  Its graph keys are the schedule round and
whether a step gossips.

CUDA graphs exist on the card only: ``graph_train_step`` raises on a CPU
state, and on the tree path, which stays eager.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.train import (build_train_step, init_state,
                               make_gossip_schedule)
from repro_torch.train.graphs import graph_train_step

torch.set_num_threads(1)  # xdist workers share the cores

A, SEQ, STEPS = 4, 16, 3

CASES = {
    "ring": {},
    "round_robin": dict(topology="exp", gossip_schedule="round_robin"),
    "gossip_every_2": dict(gossip_every=2),
    "warmup_cosine": dict(warmup_steps=2, total_steps=6),
    "int8_wire": dict(wire="int8"),
    "exp_rolls": dict(topology="exp"),
}
KEYS = {"ring": {(0, True)}, "round_robin": {(0, True), (1, True)},
        "gossip_every_2": {(0, False), (0, True)},
        "warmup_cosine": {(0, True)}, "int8_wire": {(0, True)},
        "exp_rolls": {(0, True)}}


def _setup(case, packed_bus=None):
    model = build_model(get_smoke_config("smollm_360m"))
    run = RunConfig(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                    beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                    remat=False, packed_bus=packed_bus, **CASES[case])
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    rng = np.random.default_rng(5)
    tokens = [torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                            (A, 1, SEQ)))
              for _ in range(STEPS)]
    return model, run, step, tokens


def _buffers(state):
    return [state["params"]] + [state["opt"][k] for k in sorted(state["opt"])]


@pytest.mark.parametrize("case", list(CASES))
def test_static_step_bit_equal_to_functional_step(case):
    model, run, step, tokens = _setup(case)
    want = init_state(model, run, A, seed=0, device="cpu")
    want_metrics = []
    for t in tokens:
        want, m = step(want, {"tokens": t})
        want_metrics.append(m)

    static = step.static
    state = init_state(model, run, A, seed=0, device="cpu")
    bufs = _buffers(state)
    ptrs = [b.data_ptr() for b in bufs]
    lr_scale = (torch.zeros((), dtype=torch.float32)
                if static.lr_schedule is not None else None)
    assert (lr_scale is None) == (case != "warmup_cosine")
    keys = set()
    for t, tok in enumerate(tokens):
        if lr_scale is not None:
            lr_scale.copy_(static.lr_schedule(t))
        metrics = static.run(state, {"tokens": tok}, lr_scale)
        state["step"] += 1
        keys.add(static.key(t))
        for k, v in want_metrics[t].items():
            assert torch.equal(metrics[k], v), (t, k)
    # one static state: the same buffers, written in place
    assert [b.data_ptr() for b in _buffers(state)] == ptrs
    assert all(b is c for b, c in zip(_buffers(state), bufs))
    for got, ref in zip(_buffers(state), _buffers(want)):
        assert torch.equal(got, ref)
    assert keys == KEYS[case]


def test_static_step_refuses_a_missing_or_stray_lr_scale():
    model, run, step, tokens = _setup("warmup_cosine")
    state = init_state(model, run, A, seed=0, device="cpu")
    with pytest.raises(ValueError, match="lr_scale"):
        step.static.run(state, {"tokens": tokens[0]}, None)
    model, run, step, tokens = _setup("ring")
    state = init_state(model, run, A, seed=0, device="cpu")
    with pytest.raises(ValueError, match="lr_scale"):
        step.static.run(state, {"tokens": tokens[0]}, torch.ones(()))


def test_graph_train_step_raises_on_cpu_and_on_the_tree_path():
    model, run, step, tokens = _setup("ring")
    state = init_state(model, run, A, seed=0, device="cpu")
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA graphs need"):
        graph_train_step(step, state, {"tokens": tokens[0]})
    model, run, step, tokens = _setup("ring", packed_bus=False)
    assert step.static is None
    state = init_state(model, run, A, seed=0, device="cpu")
    with pytest.raises(ValueError, match="tree path"):
        graph_train_step(step, state, {"tokens": tokens[0]})
    assert ops.launch_counts() == before


def test_cli_eager_flag_and_mode_line(capsys):
    from repro_torch.launch import train as cli
    args = ["--device", "cpu", "--arch", "smollm_360m", "--smoke", "--steps",
            "1", "--agents", str(A), "--seq", str(SEQ), "--gossip-engine",
            "ppermute", "--agents-per-device", str(A), "--fused-kernel"]
    cli.main(args)
    assert "step=eager (CPU)" in capsys.readouterr().out
    cli.main(args + ["--eager"])
    assert "step=eager (--eager)" in capsys.readouterr().out
