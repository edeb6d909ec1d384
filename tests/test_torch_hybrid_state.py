"""``remat`` and checkpoints of the port's hybrid family
(``jamba_1_5_large_398b``, the smoke config's 8-layer period), beside
``test_torch_hybrid_train.py``, whose run settings it takes.

* ``remat``: ``"full"`` and ``"dots"`` give gradients bit-equal to
  ``remat=False`` on the hybrid model.
* Checkpoints: a bf16 hybrid bus state under ``ssm:0,moe`` (its router
  and Mamba state leaves f32) saved by the reference loads in the port
  and saves back byte for byte; its consensus export loads with every
  leaf's dtype.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.configs.base import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.train import checkpoint as jckpt
from repro.train import init_state as jinit_state

from repro_torch.configs import get_smoke_config as tget_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.models import build_model
from repro_torch.train import checkpoint, init_state

from test_torch_hybrid_train import A, ARCH, GROUPS, _layouts, _run_kw
from test_torch_mamba_train import _grads

torch.set_num_threads(1)  # xdist workers share the cores


def test_remat_gradients_are_bit_equal():
    model = build_model(tget_smoke_config(ARCH))
    params = model.init(torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab_size, (2, 24)))
    loss, want = _grads(model, params, tokens, remat=False)
    for policy in ("full", "dots"):
        got_loss, got = _grads(model, params, tokens, remat=True,
                               remat_policy=policy)
        assert torch.equal(got_loss, loss), policy
        for g, w in zip(got, want):
            assert torch.equal(g, w), policy


def test_bf16_hybrid_state_files_load_in_either_package(tmp_path):
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="bfloat16")
    jmodel = jbuild_model(cfg)
    jrun = JRunConfig(**_run_kw(GROUPS))
    jstate = jinit_state(jmodel, jrun, A, jax.random.PRNGKey(1))
    jlayout, layout = _layouts(GROUPS, "bfloat16")
    jfile, pfile = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jckpt.save_state(jfile, jstate, layout=jlayout)
    model = build_model(dataclasses.replace(tget_smoke_config(ARCH),
                                            dtype="bfloat16"))
    run = RunConfig(**_run_kw(GROUPS))
    like = init_state(model, run, A, device="cpu")
    state = checkpoint.load_state(jfile, like, layout=layout)
    assert torch.equal(state["params"], torch.from_numpy(
        np.array(jstate["params"])))
    checkpoint.save_state(pfile, state, layout=layout)
    with np.load(jfile) as fj, np.load(pfile) as fp:
        assert sorted(fj.files) == sorted(fp.files)
        for k in fj.files:
            assert fj[k].dtype.str == fp[k].dtype.str, k
            assert fj[k].tobytes() == fp[k].tobytes(), k
        assert fp["params|blocks|1|moe|router"].dtype == np.float32
        assert fp["params|blocks|0|ssm|A_log"].dtype == np.float32
        assert fp["params|blocks|1|moe|w_gate"].dtype.str == "|V2"
        assert fp["params|blocks|4|attn|wq"].dtype.str == "|V2"
    export = str(tmp_path / "consensus.npz")
    checkpoint.export_consensus(pfile, export)
    params = checkpoint.load_consensus(export, model.meta(), device="cpu")
    for path, t in model.meta().items():
        assert params[path].dtype == t.dtype and params[path].shape == \
            t.shape, path
