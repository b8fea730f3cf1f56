"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA card and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the rest of the
suite.) Tolerances as in ``chip_smoke.py``: the decoder stack at bf16,
max |err| / max |plain| <= 2e-2 (the same bf16 rounding points, other
f32 summation orders); the FLAME decode in f32, atol 1e-4.
"""

import pytest
import torch


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [16, 111])
def test_decoder_kernel_matches_plain(lq):
    from msmd_tpu_torch.measure import decoder_case
    from msmd_tpu_torch.ops.kernels import decoder as kd

    args = decoder_case(_card(), Be=6, lq=lq, L=2, seed=1)
    before = kd.fused_decoder_forward.launches
    with torch.no_grad():
        got = kd.fused_decoder_forward(*args)
        want = kd.fused_decoder_forward_plain(*args)
    torch.cuda.synchronize()
    assert kd.fused_decoder_forward.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max() / want.abs().max()) <= 2e-2


@pytest.mark.cuda
def test_decoder_wrapper_refuses_what_the_kernel_does_not_take():
    from msmd_tpu_torch.measure import decoder_case
    from msmd_tpu_torch.ops.kernels import decoder as kd

    pack, kmem, vmem, x, aux, H, vmw = decoder_case(_card(), Be=2, lq=16, L=1)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        kd.fused_decoder_forward({**pack, "wqkv": pack["wqkv"].float()}, kmem, vmem, x, aux, H, vmw)
    with pytest.raises(ValueError, match="contiguous"):
        xt = x.transpose(0, 1).contiguous().transpose(0, 1)
        kd.fused_decoder_forward(pack, kmem, vmem, xt, aux, H, vmw)
    with pytest.raises(ValueError, match="must be on"):
        kd.fused_decoder_forward(pack, kmem.cpu(), vmem, x, aux, H, vmw)


@pytest.mark.cuda
def test_lbs_kernel_matches_plain():
    from msmd_tpu_torch.measure import lbs_case
    from msmd_tpu_torch.ops.kernels import lbs as kl

    fused, (betas_ext, rt) = lbs_case(_card(), N=130, V=5023, seed=3)
    got = kl.skin_cuda(fused, betas_ext, rt)
    want = kl.skin_plain(fused, betas_ext, rt)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    before = kl.flame_vertices.launches
    z = torch.zeros(4, 100, device=betas_ext.device)
    verts = kl.flame_vertices(fused, z, z[:, :50], z[:, :6])
    assert kl.flame_vertices.launches == before + 1 and verts.shape == (4, 5023, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kl.skin_cuda(fused, betas_ext.t().contiguous().t(), rt)
