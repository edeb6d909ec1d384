"""Decentralized stochastic optimizers: the counterpart of
``repro/core/optimizers.py``.

Every algorithm of the JAX package's ``ALGORITHMS`` runs on a tree — a
``{path: tensor}`` dict, or one tensor — whose leaves carry a leading
agent axis A, with a gossip operator ``mix(tree) -> tree``
(:mod:`repro_torch.core.mixing`):

===========  ==================================================================
EDM          the paper's Algorithm 1, Exact-Diffusion with Momentum
ED/D²        EDM with β = 0
EDM-EF       EDM with an error-feedback bf16 gossip payload
DSGD         x ← W(x − α g)
DmSGD        m ← βm + (1−β)g;  x ← W(x − αm)
DSGT         gradient tracking, adapt-then-combine
DSGT-HB      gradient tracking with heavy-ball momentum
DecentLaM    m ← βm + (1−β)g;  x ← Wx − αm
QG-DmSGD     quasi-global momentum
===========  ==================================================================

::

    opt = make_optimizer("edm", alpha=0.05, beta=0.9, mix=make_mixer(topo))
    state = opt.init(params)                  # leaves: (A, ...)
    params, state = opt.step(params, grads, state)

The state trees keep the leaf dtypes, and :func:`_lincomb` sums its terms
in the JAX module's order, rounding after each operation as eager
PyTorch does.  ``make_edm(use_fused_kernel=True)`` runs the EDM chain as
one CUDA kernel launch per leaf
(:func:`repro_torch.kernels.ops.edm_update_tree`).

The bus-resident EDM, :func:`make_edm_bus` and :func:`make_edm_bus_ef`,
runs the same recursion over ``(A, rows, 128)`` bus buffers::

    m   ← β m + (1−β) g
    ψ'  ← x − α m
    φ   ← ψ' + x − ψ
    x   ← Σ_j w_ij φ_j            (gossip)

with ``use_fused_kernel=True`` as ONE CUDA kernel launch over the whole
bus (:func:`repro_torch.kernels.ops.edm_update_bus`), otherwise the plain
PyTorch chain; :func:`make_edm_bus_ef` is the same step with the
error-feedback-compressed gossip wire (bf16 / int8): it sends
``Q(φ + e)`` and carries the residual ``e``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import edm_update_ref

from .mixing import tree_map
from .wire import WireCodec, encode_ef

__all__ = ["DecOptimizer", "ALGORITHMS", "make_optimizer", "make_edm",
           "make_ed", "make_edm_ef", "make_dsgd", "make_dmsgd", "make_dsgt",
           "make_dsgt_hb", "make_decentlam", "make_qg", "make_edm_bus",
           "make_edm_bus_ef"]

State = Dict[str, Any]
Mixer = Callable[[Any], Any]


@dataclasses.dataclass(frozen=True)
class DecOptimizer:
    name: str
    init: Callable[[Any], State]
    step: Callable[[Any, Any, State], tuple]


def _zip_map(fn: Callable, *trees):
    """``fn`` over the matching leaves of trees of one structure."""
    if isinstance(trees[0], Mapping):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _lincomb(*pairs):
    """``Σ c_k · tree_k`` leafwise: ``c₀·t₀``, then ``+ c_k·t_k`` in
    order, each operation rounded to the leaf dtype."""
    coeffs = [c for c, _ in pairs]

    def f(*leaves):
        out = coeffs[0] * leaves[0]
        for c, leaf in zip(coeffs[1:], leaves[1:]):
            out = out + c * leaf
        return out

    return _zip_map(f, *(t for _, t in pairs))


# ---------------------------------------------------------------------------
# EDM — the paper's Algorithm 1, tree-resident
# ---------------------------------------------------------------------------

def make_edm(alpha: float, beta: float, mix: Mixer,
             use_fused_kernel: bool = False) -> DecOptimizer:
    """Exact-Diffusion with Momentum (paper Algorithm 1), per agent::

        m   ← β m + (1-β) g
        ψ'  ← x − α m                   (adapt)
        φ   ← ψ' + x − ψ                (correct)
        x   ← Σ_j w_ij φ_j              (combine: gossip)

    State ``{m, psi}``, ψ(0) = x(0) (a copy), so step 0 is
    x ← W(x − α m).  With β = 0 this is ED/D².
    ``use_fused_kernel=True`` runs the chain through
    :func:`repro_torch.kernels.ops.edm_update_tree`: one EDM kernel
    launch per leaf on the card, the same pack and plain chain on the
    CPU."""

    def init(params) -> State:
        return {"m": _zeros_like(params), "psi": tree_map(torch.clone,
                                                            params)}

    def step(params, grads, state: State):
        if use_fused_kernel:
            m_new, phi, psi_new = kops.edm_update_tree(
                params, grads, state["m"], state["psi"], alpha=alpha,
                beta=beta)
        else:
            m_new = _lincomb((beta, state["m"]), ((1.0 - beta), grads))
            psi_new = _lincomb((1.0, params), (-alpha, m_new))
            phi = _lincomb((1.0, psi_new), (1.0, params),
                           (-1.0, state["psi"]))
        return mix(phi), {"m": m_new, "psi": psi_new}

    return DecOptimizer("edm", init, step)


def make_ed(alpha: float, mix: Mixer, **_) -> DecOptimizer:
    """ED/D²: momentum-free exact diffusion (EDM with β = 0)."""
    opt = make_edm(alpha, 0.0, mix)
    return DecOptimizer("ed", opt.init, opt.step)


def make_edm_ef(alpha: float, beta: float, mix: Mixer,
                compress_dtype: str = "bfloat16", **_) -> DecOptimizer:
    """EDM with an error-feedback-compressed gossip payload: each agent
    sends ``Q(φ + e)`` (a round trip through ``compress_dtype``) and keeps
    ``e' = (φ + e) − Q(φ + e)``; state ``{m, psi, e}``."""
    dt = getattr(torch, compress_dtype)

    def init(params) -> State:
        return {"m": _zeros_like(params),
                "psi": tree_map(torch.clone, params),
                "e": _zeros_like(params)}

    def step(params, grads, state: State):
        m_new = _lincomb((beta, state["m"]), ((1.0 - beta), grads))
        psi_new = _lincomb((1.0, params), (-alpha, m_new))
        phi = _lincomb((1.0, psi_new), (1.0, params), (-1.0, state["psi"]))
        corr = _lincomb((1.0, phi), (1.0, state["e"]))
        payload = tree_map(lambda c: c.to(dt).to(c.dtype), corr)
        e_new = _lincomb((1.0, corr), (-1.0, payload))
        return mix(payload), {"m": m_new, "psi": psi_new, "e": e_new}

    return DecOptimizer("edm_ef", init, step)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def make_dsgd(alpha: float, mix: Mixer, **_) -> DecOptimizer:
    """DSGD: x ← W(x − α g) (adapt-then-combine)."""

    def init(params):
        return {}

    def step(params, grads, state):
        return mix(_lincomb((1.0, params), (-alpha, grads))), state

    return DecOptimizer("dsgd", init, step)


def make_dmsgd(alpha: float, beta: float, mix: Mixer, **_) -> DecOptimizer:
    """DmSGD, the paper's eqs. (3.2)–(3.3): m ← βm + (1−β)g;
    x ← W(x − αm).  Keeps the heterogeneity bias EDM removes."""

    def init(params):
        return {"m": _zeros_like(params)}

    def step(params, grads, state):
        m = _lincomb((beta, state["m"]), (1.0 - beta, grads))
        return mix(_lincomb((1.0, params), (-alpha, m))), {"m": m}

    return DecOptimizer("dmsgd", init, step)


def make_dsgt(alpha: float, mix: Mixer, **_) -> DecOptimizer:
    """DSGT, adapt-then-combine: y ← W y + g − g_prev;
    x ← W(x − α y).  State ``{y, g_prev}`` from 0, so y⁰ = g⁰."""

    def init(params):
        return {"y": _zeros_like(params), "g_prev": _zeros_like(params)}

    def step(params, grads, state):
        y = _lincomb((1.0, mix(state["y"])), (1.0, grads),
                     (-1.0, state["g_prev"]))
        x = mix(_lincomb((1.0, params), (-alpha, y)))
        return x, {"y": y, "g_prev": grads}

    return DecOptimizer("dsgt", init, step)


def make_dsgt_hb(alpha: float, beta: float, mix: Mixer, **_) -> DecOptimizer:
    """DSGT with heavy-ball momentum: y ← W y + g − g_prev;
    m ← βm + (1−β)y;  x ← W(x − αm)."""

    def init(params):
        return {"y": _zeros_like(params), "g_prev": _zeros_like(params),
                "m": _zeros_like(params)}

    def step(params, grads, state):
        y = _lincomb((1.0, mix(state["y"])), (1.0, grads),
                     (-1.0, state["g_prev"]))
        m = _lincomb((beta, state["m"]), (1.0 - beta, y))
        x = mix(_lincomb((1.0, params), (-alpha, m)))
        return x, {"y": y, "g_prev": grads, "m": m}

    return DecOptimizer("dsgt_hb", init, step)


def make_decentlam(alpha: float, beta: float, mix: Mixer,
                   **_) -> DecOptimizer:
    """DecentLaM: momentum outside the gossip, m ← βm + (1−β)g;
    x ← Wx − αm."""

    def init(params):
        return {"m": _zeros_like(params)}

    def step(params, grads, state):
        m = _lincomb((beta, state["m"]), (1.0 - beta, grads))
        return _lincomb((1.0, mix(params)), (-alpha, m)), {"m": m}

    return DecOptimizer("decentlam", init, step)


def make_qg(alpha: float, beta: float, mix: Mixer, **_) -> DecOptimizer:
    """Quasi-global momentum: x½ ← x − α(g + βm); x' ← W x½;
    m ← βm + (1−β)(x − x')/α."""

    def init(params):
        return {"m": _zeros_like(params)}

    def step(params, grads, state):
        d = _lincomb((1.0, grads), (beta, state["m"]))
        x_new = mix(_lincomb((1.0, params), (-alpha, d)))
        m = _lincomb((beta, state["m"]),
                     ((1.0 - beta) / alpha,
                      _lincomb((1.0, params), (-1.0, x_new))))
        return x_new, {"m": m}

    return DecOptimizer("qg", init, step)


ALGORITHMS = {
    "edm": make_edm,
    "edm_ef": make_edm_ef,
    "ed": make_ed,
    "dsgd": make_dsgd,
    "dmsgd": make_dmsgd,
    "dsgt": make_dsgt,
    "dsgt_hb": make_dsgt_hb,
    "decentlam": make_decentlam,
    "qg": make_qg,
}


def make_optimizer(name: str, alpha: float, mix: Mixer, beta: float = 0.9,
                   **kwargs) -> DecOptimizer:
    """Build ``ALGORITHMS[name]``: ``dsgd``, ``dsgt`` and ``ed`` take no
    β; the others take ``beta``; ``kwargs`` pass through (only ``edm``
    reads ``use_fused_kernel``)."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; have "
                         f"{sorted(ALGORITHMS)}")
    fn = ALGORITHMS[name]
    if name in ("dsgd", "dsgt", "ed"):
        return fn(alpha=alpha, mix=mix, **kwargs)
    return fn(alpha=alpha, beta=beta, mix=mix, **kwargs)


# ---------------------------------------------------------------------------
# EDM on the packed bus
# ---------------------------------------------------------------------------


def make_edm_bus(alpha: float, beta: float, mix: Callable, *,
                 use_fused_kernel: bool = False,
                 phi_out: Optional[Callable] = None) -> DecOptimizer:
    """Bus-resident EDM.  ``init(x_bus)`` → ``{"m": 0, "psi": x}``;
    ``step(x_bus, g_bus, state)`` → ``(mix(φ), {"m": m', "psi": ψ'})``.

    The step writes m' and ψ' over the state's own ``m`` and ``psi``
    buffers (each element is read before it is written, so this is exact);
    it consumes its state as the JAX step donates it, which keeps one bus
    copy of each off the peak memory at full width.  Zero-preservation
    keeps the layout's pad region zero.  ``phi_out(x_bus)``, when given,
    returns the buffer φ is written into (None: a new one) — the peer
    ring's shared payload across ranks."""

    def init(x_bus: torch.Tensor) -> State:
        # ψ(0) = x(0) as a DISTINCT buffer: ψ is updated in place.
        return {"m": torch.zeros_like(x_bus), "psi": x_bus.clone()}

    def step(x_bus, g_bus, state: State):
        m, psi = state["m"], state["psi"]
        out = (m, psi, None if phi_out is None else phi_out(x_bus))
        if use_fused_kernel:
            m_new, psi_new, phi = kops.edm_update_bus(
                x_bus, g_bus, m, psi, alpha=alpha, beta=beta, out=out)
        else:
            m_new, psi_new, phi = edm_update_ref(
                x_bus, g_bus, m, psi, alpha=alpha, beta=beta, out=out)
        return mix(phi), {"m": m_new, "psi": psi_new}

    return DecOptimizer("edm_bus", init, step)


def make_edm_bus_ef(alpha: float, beta: float, mix: Callable,
                    codec: WireCodec, *, use_fused_kernel: bool = False,
                    error_feedback: bool = True,
                    payload_out: Optional[Callable] = None) -> DecOptimizer:
    """Bus-resident EDM with an error-feedback-compressed wire.  Per step::

        m'  = β m + (1-β) g
        ψ'  = x − α m'
        c   = (ψ' + x − ψ) + e          (φ plus the carried residual)
        pay = encode(c)                 (the wire payload, codec format)
        e'  = c − decode(pay)           (sender-local, carried across rounds)
        x'  = mix(pay)                  (wire-coded engine → f32 mix)

    ``mix`` takes the codec's payload and returns the f32 mixed bus
    (``make_mixer(..., wire=codec)``).  State is ``{m, psi, e}``; m', ψ'
    and e' are written over the state's own buffers, as
    :func:`make_edm_bus` does.  ``use_fused_kernel=True`` runs the chain,
    the quantization and the residual as ONE CUDA kernel launch
    (:func:`repro_torch.kernels.ops.edm_update_bus_ef`); otherwise the
    plain chain and :func:`repro_torch.core.wire.encode_ef`.

    ``error_feedback=False`` drops the residual (``pay = encode(φ)``,
    ``e`` stays 0): the naive-quantization negative control, not a
    production mode.  ``payload_out(x_bus)``, when given, returns the
    buffers the fused kernel writes the payload into (a peer table's slot
    across ranks: no copy before the gossip), or None."""

    def init(x_bus: torch.Tensor) -> State:
        return {"m": torch.zeros_like(x_bus), "psi": x_bus.clone(),
                "e": torch.zeros_like(x_bus)}

    def step(x_bus, g_bus, state: State):
        m, psi, e = state["m"], state["psi"], state["e"]
        if use_fused_kernel and error_feedback and codec.fmt != "f32":
            m_new, psi_new, payload, e_new = kops.edm_update_bus_ef(
                x_bus, g_bus, m, psi, e, alpha=alpha, beta=beta,
                fmt=codec.fmt, block_rows=codec.block_rows,
                out=(m, psi, e), payload_out=None if payload_out is None
                else payload_out(x_bus))
        else:
            m_new, psi_new, phi = edm_update_ref(
                x_bus, g_bus, m, psi, alpha=alpha, beta=beta,
                out=(m, psi, None))
            if error_feedback:
                payload, e_new = encode_ef(codec, phi.add_(e))
                e_new = e.copy_(e_new)
            else:
                payload, e_new = codec.encode(phi), e
        return mix(payload), {"m": m_new, "psi": psi_new, "e": e_new}

    return DecOptimizer("edm_bus_ef", init, step)
