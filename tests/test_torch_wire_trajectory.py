"""The slice as a whole: the port's 4-agent packed-bus EDM training with
the error-feedback gossip wire against the JAX package's fused one-device
ppermute path.

JAX side: ``build_train_step`` with ``gossip_engine="ppermute"`` on a
1-device mesh (``make_gossip_mesh(4, agents_per_device=4)``), the fused
Pallas kernels (interpret mode on the CPU: the EF update and the
decode-combine) and the run's gossip schedule.  Port side: the same
configuration on ``device="cpu"`` (the kernels' plain versions).  Both
start from the JAX package's carried state (``{params, opt: {m, psi, e},
step}``, through :func:`repro_torch.weights.train_state_from_arrays`) and
take 3 steps on the JAX ``SyntheticLM`` tokens.

Tolerances, with the reason: XLA contracts FMAs in the EF update, so
``c = φ + e`` differs in its last bits and a ``c`` within an ulp of a
rounding tie quantizes one quantum apart on the two sides; a few such
flips per step are expected on the smoke bus, and error feedback re-sends
each flip on the next step.  So loss and consensus agree per step at
rtol 1e-3; the final x, m, ψ and e buses element-wise within
``QUANTA`` quanta plus 1e-5 (the f32 drift ``test_torch_train.py``
allows), a quantum being the wire's largest step at the magnitude of x's
tile
(which the payload ``c ≈ φ`` carries) — the int8 scale, or one bf16 ulp
of the tile's absmax — times the largest gossip weight; and at most
``FLIP_SHARE`` of the elements off by more than 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.mesh import gossip_agent_axes, make_gossip_mesh
from repro.models import build_model as jbuild_model
from repro.train import build_train_step as jbuild_train_step
from repro.train import init_state as jinit_state
from repro.train import make_gossip_schedule as jmake_gossip_schedule

from repro_torch import weights
from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.kernels.edm_update import BLOCK_ROWS
from repro_torch.models import build_model
from repro_torch.train import build_train_step, make_gossip_schedule

torch.set_num_threads(1)  # xdist workers share the cores

A, SEQ, STEPS = 4, 16, 3
QUANTA = 4
FLIP_SHARE = 1e-3


def _run_kw(wire, gossip_every, schedule):
    return dict(global_batch=A, seq_len=SEQ, algorithm="edm", alpha=0.2,
                beta=0.9, gossip_engine="ppermute", agents_per_device=A,
                gossip_every=gossip_every, remat=False, wire=wire,
                topology="exp" if schedule == "round_robin" else "ring",
                gossip_schedule=schedule)


def _jax_trajectory(kw):
    model = jbuild_model(get_smoke_config("smollm_360m"))
    run = JRunConfig(**kw)
    mesh = make_gossip_mesh(A, agents_per_device=A)
    step = jax.jit(jbuild_train_step(
        model, run, jmake_gossip_schedule(run, A), use_fused_kernel=True,
        mesh=mesh, agent_axes=gossip_agent_axes(mesh)))
    state = jinit_state(model, run, A, jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state)
    data = JSyntheticLM(vocab_size=model.cfg.vocab_size, seq_len=SEQ,
                        n_agents=A)
    batches, metrics = [], []
    for t in range(STEPS):
        batch = data.sample(jax.random.PRNGKey(100 + t), 1)
        batches.append(np.array(batch["tokens"]))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return init, batches, metrics, jax.tree.map(np.array, state)


def _port_trajectory(init, batches, kw):
    model = build_model(tget_smoke_config("smollm_360m"))
    run = RunConfig(**kw)
    step = build_train_step(model, run, make_gossip_schedule(run, A),
                            use_fused_kernel=True, device="cpu")
    state = weights.train_state_from_arrays(init)
    metrics = []
    for tokens in batches:
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _quantum(x: np.ndarray, wire: str, w_max: float) -> np.ndarray:
    """Per element: the wire's largest step in the element's
    ``(BLOCK_ROWS, 128)`` tile — the int8 scale absmax / 127, or one bf16
    ulp of the absmax, 2⁻⁸·absmax — times the largest gossip weight."""
    tiles = x.reshape(A, -1, BLOCK_ROWS * 128)
    absmax = np.abs(tiles).max(-1, keepdims=True)
    step = absmax / 127 if wire == "int8" else 2.0 ** -8 * absmax
    return np.broadcast_to(step * w_max, tiles.shape).reshape(x.shape)


@pytest.mark.parametrize("wire,gossip_every,schedule", [
    ("int8", 1, "static"), ("int8", 2, "static"), ("bf16", 1, "static"),
    ("int8", 1, "round_robin")])
def test_wire_trajectory_matches_reference(wire, gossip_every, schedule):
    kw = _run_kw(wire, gossip_every, schedule)
    init, batches, jmetrics, jfinal = _jax_trajectory(kw)
    assert set(init["opt"]) == {"m", "psi", "e"}
    assert not init["opt"]["e"].any()
    tmetrics, tfinal = _port_trajectory(init, batches, kw)
    for t, (jm, tm) in enumerate(zip(jmetrics, tmetrics)):
        for key in ("loss", "consensus", "grad_norm"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-3,
                                       err_msg=f"step {t} {key}")
    assert tfinal["step"] == int(jfinal["step"]) == STEPS
    # the payload c ≈ φ carries x's magnitude: its quantum bounds them all
    bound = QUANTA * _quantum(jfinal["params"], wire, w_max=0.5) + 1e-5
    pairs = [("params", tfinal["params"], jfinal["params"])] + [
        (k, tfinal["opt"][k], jfinal["opt"][k]) for k in ("m", "psi", "e")]
    for name, got, want in pairs:
        diff = np.abs(got.numpy() - want)
        assert np.all(diff <= bound), (name, (diff / bound).max())
        assert np.mean(diff > 1e-5) <= FLIP_SHARE, (name,
                                                    np.mean(diff > 1e-5))
    # the wire really carried a residual and the gossip really mixed
    assert np.abs(tfinal["opt"]["e"].numpy()).max() > 0
    assert tmetrics[-1]["consensus"] > 0
