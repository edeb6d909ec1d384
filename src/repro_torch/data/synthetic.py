"""Synthetic heterogeneous token streams: the counterpart of
``repro/data/synthetic.py::SyntheticLM``.

The tables — a shared order-1 Markov backbone and a per-agent
Dirichlet-tilted unigram — come from ``np.random.default_rng(seed)`` in the
same order as in the JAX package, so they are identical to the reference's.
Sampling draws from a ``torch.Generator`` instead of ``jax.random``, so the
tokens differ from the reference's; tests feed the reference's tokens to
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

__all__ = ["SyntheticLM"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    n_agents: int
    phi: float = 1.0          # Dirichlet concentration; smaller = more hetero
    mix: float = 0.5          # weight of the agent-specific unigram tilt
    sharpness: float = 4.0    # Markov logit scale: higher = lower entropy
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V = min(self.vocab_size, 256)  # active head of the vocab
        self._V = V
        self.trans_logits = (rng.normal(size=(V, V)).astype(np.float32)
                             * self.sharpness)
        tilt = rng.dirichlet(np.full(V, self.phi), size=self.n_agents)
        self.tilt_logits = np.log(tilt + 1e-8).astype(np.float32)

    def sample(self, generator: torch.Generator,
               per_agent_batch: int) -> Dict[str, torch.Tensor]:
        """Returns ``{"tokens": (A, b, S) int64}`` on ``generator.device``:
        a uniform first token, then Markov steps drawn by Gumbel-max from
        ``trans[tok]·(1 − mix) + tilt[agent]·mix``."""
        A, b, S, V = self.n_agents, per_agent_batch, self.seq_len, self._V
        dev = generator.device
        trans = torch.as_tensor(self.trans_logits, device=dev)
        tilt = torch.as_tensor(self.tilt_logits, device=dev)[:, None, :]
        tok = torch.randint(0, V, (A, b), generator=generator, device=dev)
        toks = [tok]
        for _ in range(S - 1):
            logits = trans[tok] * (1 - self.mix) + tilt * self.mix
            u = torch.rand(logits.shape, generator=generator, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            tok = (logits + gumbel).argmax(dim=-1)
            toks.append(tok)
        return {"tokens": torch.stack(toks, dim=-1)}
