"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Bit-equality: the kernels round every product and sum as the plain
versions do (explicitly rounded intrinsics, no FMA contraction).  These
tests need a CUDA device and nvcc and skip elsewhere; this file imports
nothing of JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

ALPHA, BETA = 0.2, 0.9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _edm_inputs(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device)
            for _ in range(4)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(4, 1024, 128), (3, 24, 128),
                                   (1, 8, 128)])
def test_cuda_edm_update_bit_equal_to_plain(cuda, shape):
    x, g, m, psi = _edm_inputs(shape, cuda, seed=3)
    want = ref.edm_update_ref(x, g, m, psi, alpha=ALPHA, beta=BETA)
    before = ops.launch_counts()["edm_update"]
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    assert ops.launch_counts()["edm_update"] == before + 1
    for w, o in zip(want, got):
        assert torch.equal(w, o)
    got = ops.edm_update_bus(x, g, m, psi, alpha=ALPHA, beta=BETA,
                             out=(m, psi, None))
    assert got[0].data_ptr() == m.data_ptr()
    for w, o in zip(want, got):
        assert torch.equal(w, o)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 3, 5, 16])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.float32)])
def test_cuda_gossip_axpy_bit_equal_to_plain(cuda, n, dtype, out_dtype):
    gen = torch.Generator(device=cuda).manual_seed(n)
    operands = [torch.randn(4, 100, 128, generator=gen,
                            device=cuda).to(dtype) for _ in range(n)]
    weights = [1.0 / (k + 3) for k in range(n)]
    got = ops.gossip_axpy(operands, weights, out_dtype=out_dtype)
    want = ref.gossip_axpy_ref(operands, weights, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.requires_cuda
def test_cuda_wrappers_check_their_inputs(cuda):
    x, g, m, psi = _edm_inputs((2, 8, 128), cuda, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.edm_update_bus(x, g, m, psi.transpose(1, 2).contiguous()
                           .transpose(1, 2), alpha=ALPHA, beta=BETA)
    with pytest.raises(ValueError, match="operands"):
        ops.gossip_axpy([x] * 17, [0.0] * 17)
    with pytest.raises(ValueError, match="dtype"):
        ops.gossip_axpy([x.double()], [1.0])


@pytest.mark.requires_cuda
def test_cuda_fused_step_bit_equal_to_plain_step(cuda):
    """One EDM + ring-gossip step on a small bus: fused kernels against
    the plain chain and weighted sum."""
    from repro_torch.core import build_mixer, make_edm_bus, ring

    x, g, m, psi = _edm_inputs((4, 64, 128), cuda, seed=5)
    outs = []
    for fused in (True, False):
        mix = build_mixer(ring(4), mode="static", engine="ppermute",
                          agents_per_device=4, use_fused_kernel=fused)
        opt = make_edm_bus(ALPHA, BETA, mix, use_fused_kernel=fused)
        x2, st = opt.step(x, g, {"m": m.clone(), "psi": psi.clone()})
        outs.append((x2, st["m"], st["psi"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert np.isfinite(outs[0][0].cpu().numpy()).all()
