"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA card and skips without one; the
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``-s`` shows each K6, K8 and K9 case's max |err| / max |plain|, and each
product of the warp-specialized GEMM that K6 and K9 run.)

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the rest of the
suite.) Tolerances as in ``chip_smoke.py``: the decoder stack (K1 in both
modes, K2, which must also equal K1's kernel bit for bit), the decoder's
Hopper GEMM alone against the f32 product of its bf16 operands, and the
batch-1 sampler kernels, the training FFN block K7 (forward, and each
of its seven gradients) and the guided window's layer kernels K6, K8 and
K9 and each product of their warp-specialized GEMM at bf16, max |err| /
max |plain| <= 2e-2 (the same bf16 rounding points, other f32 summation
orders); the decoder's Hopper GEMM on its warp-specialised pipeline also
bit for bit against the tile loop that K2 runs; K7's mask bits exactly;
the FLAME decode in f32, atol 1e-4, and
its backward (K5 bwd, and the gradients through ``flame_vertices``) within
1e-4 of max |plain|.
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
@pytest.mark.parametrize("Be,lq,width,tile", [(2, 16, 1, 2), (4, 111, 1, 4), (2, 111, 0, 2), (6, 37, 0, 3),
                                              (4, 16, 3, 2)])
def test_decoder_flat_kernel_matches_plain(Be, lq, width, tile):
    """K1's flat-mask mode: the identity band, the full masked cross with
    and without the alignment band, one tile and several, lq not a
    multiple of 16 or of the 64-row key blocks."""
    from msmd_tpu_torch.measure import decoder_flat_case
    from msmd_tpu_torch.ops.kernels import decoder as kd

    args = decoder_flat_case(_card(), Be=Be, lq=lq, width=width, tile=tile, L=2, seed=9)
    before = (kd.fused_decoder_forward.launches, kd.fused_decoder_forward_flat.launches)
    with torch.no_grad():
        got = kd.fused_decoder_forward(*args[:7], self_mask=args[7], cross_mask=args[8], tile_entries=args[9])
        want = kd.fused_decoder_forward_plain(*args)
    torch.cuda.synchronize()
    assert (kd.fused_decoder_forward.launches, kd.fused_decoder_forward_flat.launches) == (before[0], before[1] + 1)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    print(f"K1 flat Be={Be} lq={lq} width={width} tile={tile} rel_err={_rel(got, want):.3e}")
    assert _rel(got, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Be,tile,width", [(16, 8, 0), (10, 5, 1), (12, 6, 2)])
def test_decoder_flat_at_hopper_gemm_rows_matches_plain(Be, tile, width):
    """K1's flat-mask mode at 1024 rows and more (lq = 111, the denoiser's
    tiles: the full cross, the identity band, the alignment band), where
    it runs its chain of launches on the Hopper GEMM: within 2e-2 of the
    plain twin and bit-equal across two calls; the library picks that
    route where ``small_stack.flat_uses_chain`` says so, and refuses the
    small stack's plan and phase stamps there."""
    from msmd_tpu_torch.measure import decoder_flat_case
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels.small_stack import flat_uses_chain

    args = decoder_flat_case(_card(), Be=Be, width=width, tile=tile, L=2, seed=21)
    for n in (2, 8, 9, 10, Be):
        assert kd._lib().msmd_flat_uses_chain(n, 111, 512, 2048) == int(flat_uses_chain(n, 111, 512, 2048))
    assert flat_uses_chain(Be, 111, 512, 2048)
    with torch.no_grad():
        got, again, want = (kd.fused_decoder_forward_flat(*args), kd.fused_decoder_forward_flat(*args),
                            kd.fused_decoder_forward_plain(*args))
    torch.cuda.synchronize()
    print(f"flat chain Be={Be} tile={tile} width={width} rel_err={_rel(got, want):.3e}")
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="chain"):
        kd.flat_stamps(*args)
    with pytest.raises(RuntimeError):
        kd.flat_plan(Be, 111, 512, 8, 2, 2048, tile, width == 1)


@pytest.mark.cuda
def test_decoder_flat_wrapper_refuses_what_the_kernel_does_not_take():
    from msmd_tpu_torch.measure import decoder_flat_case
    from msmd_tpu_torch.ops.kernels import decoder as kd

    pack, kmem, vmem, x, aux, H, vmw, sm, pm, tile = decoder_flat_case(_card(), Be=4, lq=16, tile=2, L=1)
    with pytest.raises(ValueError, match="shape"):
        kd.fused_decoder_forward_flat(pack, kmem, vmem, x, aux, H, vmw, sm[:-1], pm, tile)
    with pytest.raises(ValueError, match="does not divide"):
        kd.fused_decoder_forward_flat(pack, kmem, vmem, x, aux, H, vmw, sm, pm, 3)
    with pytest.raises(ValueError, match="together"):
        kd.fused_decoder_forward_flat(pack, kmem, vmem, x, None, H, vmw, sm, pm, tile)
    with pytest.raises(TypeError, match="must be torch.float32"):
        kd.fused_decoder_forward_flat(pack, kmem, vmem, x, aux, H, vmw, sm.bfloat16(), pm, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("Be,lq", [(17, 111), (96, 111)])
def test_decoder_kernel_on_the_hopper_gemm(Be, lq):
    """K1 where its four large products run on the Hopper GEMM with the
    LayerNorm fold: R = 1887 rows, a multiple of no tile height (64, 128),
    and the batch-48 shape. Each call counts its 4 L products on the
    clustered pipeline (``msmd.k1.cluster_products``); a call below 1024
    rows (Be = 6) counts none."""
    from msmd_tpu_torch.measure import decoder_case
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import gemm as kg
    from msmd_tpu_torch.utils.profiling import counters

    args = decoder_case(_card(), Be=Be, lq=lq, L=2, seed=11)
    assert kg.gemm_plan(Be * lq, 512, 2048, "resid_ln")["route"] == "wgmma"
    counted = lambda: counters().get("msmd.k1.cluster_products", 0)
    before = counted()
    with torch.no_grad():
        got = kd.fused_decoder_forward(*args)
        want = kd.fused_decoder_forward_plain(*args)
    torch.cuda.synchronize()
    print(f"K1 Be={Be} lq={lq} rel_err={_rel(got, want):.3e}")
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    assert counted() - before == 4 * 2
    small = decoder_case(_card(), Be=6, lq=lq, L=2, seed=11)
    before = counted()
    with torch.no_grad():
        kd.fused_decoder_forward(*small)
    assert counted() == before


@pytest.mark.cuda
@pytest.mark.parametrize("M", [10656, 1776, 1024])
@pytest.mark.parametrize("N,K,epilogue", [(1536, 512, "bf16"), (2048, 512, "gelu"), (512, 2048, "resid_ln"),
                                          (512, 512, "resid_ln_cross")])
def test_gemm_pipeline_matches_the_tile_loop_bit_for_bit(M, N, K, epilogue):
    """K1's four products (QKV, FFN1, FFN2 + LayerNorm, self-out + LayerNorm
    + the cross step on the motion rows, person rows e * 111 included) on
    the warp-specialised pipeline equal the 256-thread tile loop that K2
    runs (and K1 ran before), bit for bit, at Be 96 (10656 rows), Be 16
    (1776) and 1024 rows; two calls give the same bits."""
    from msmd_tpu_torch.measure import gemm_case
    from msmd_tpu_torch.ops.kernels import gemm as kg

    args, kw = gemm_case(_card(), M, N, K, epilogue, seed=13)
    call = lambda route: kg.gemm(*args[:3], epilogue, *args[3:], route=route, **kw)
    got, again, loop = call("wgmma"), call("wgmma"), call("sm90_loop")
    torch.cuda.synchronize()
    if epilogue.startswith("resid_ln"):
        assert all(torch.equal(a, b) for a, b in zip(got, loop)) and all(torch.equal(a, b) for a, b in zip(got, again))
        got = got[0]
    else:
        assert torch.equal(got, loop) and torch.equal(got, again)
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,epilogue", [(10656, 1536, 512, "bf16"), (10656, 512, 512, "resid_ln"),
                                            (10656, 2048, 512, "gelu"), (10656, 512, 2048, "resid_ln"),
                                            (1887, 1536, 512, "bf16"), (1887, 512, 2048, "resid_ln")])
def test_gemm_matches_f32_reference(M, N, K, epilogue):
    """The Hopper GEMM at K1's four product shapes (R = 10656) and at a
    ragged R, against the f32 product of the same bf16 operands with the
    same epilogue; the wmma route of the same call within the same bound."""
    from msmd_tpu_torch.measure import gemm_case
    from msmd_tpu_torch.ops.kernels import gemm as kg

    args, kw = gemm_case(_card(), M, N, K, epilogue, seed=12)
    before = kg.gemm.launches
    got = kg.gemm(*args[:3], epilogue, *args[3:], route="wgmma", **kw)
    auto = kg.gemm(*args[:3], epilogue, *args[3:], **kw)
    old = kg.gemm(*args[:3], epilogue, *args[3:], route="wmma", **kw)
    want = kg.gemm_plain(*args[:3], epilogue, *args[3:], **kw)
    torch.cuda.synchronize()
    assert kg.gemm.launches == before + 3
    if epilogue == "resid_ln":
        (got, got_b), (auto, _), (old, _), (want, want_b) = got, auto, old, want
        assert got_b.dtype == torch.bfloat16 and _rel(got_b, want_b) <= 2e-2
    assert torch.equal(got, auto) and bool(torch.isfinite(got.float()).all())
    print(f"GEMM {M}x{N}x{K} {epilogue} rel_err={_rel(got, want):.3e} wmma={_rel(old, want):.3e}")
    assert _rel(got, want) <= 2e-2 and _rel(old, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,epilogue", [(10656, 1536, 512, "bf16"), (10656, 512, 2048, "resid_ln"),
                                            (1887, 2048, 512, "gelu"), (1023, 512, 512, "resid_ln"),
                                            (222, 1536, 512, "bf16"), (10656, 384, 512, "resid_ln"),
                                            (10656, 512, 512, "resid_ln_cross"), (1776, 512, 512, "resid_ln_cross")])
def test_gemm_plan_matches_the_library(M, N, K, epilogue):
    """The pure-Python launch plan equals what the library launches on this
    card (route, tile, tiles, grid, shared memory)."""
    from msmd_tpu_torch.ops.kernels import gemm as kg

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert kg.kernel_plan(M, N, K, epilogue) == kg.gemm_plan(M, N, K, epilogue, sms=sms)


@pytest.mark.cuda
def test_gemm_wrapper_refuses_what_the_kernel_does_not_take():
    from msmd_tpu_torch.measure import gemm_case
    from msmd_tpu_torch.ops.kernels import gemm as kg

    args, kw = gemm_case(_card(), 222, 1536, 512, "bf16")
    with pytest.raises(ValueError, match="does not take M=222"):
        kg.gemm(*args, "bf16", route="wgmma", **kw)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        kg.gemm(args[0].float(), *args[1:], "bf16", **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        kg.gemm(args[0], args[1][:, :100].contiguous(), args[2][:100], "bf16")


@pytest.mark.cuda
@pytest.mark.parametrize("Be,lq", [(6, 37), (6, 111), (16, 111), (96, 111)])
def test_resident_kernel_matches_plain_and_k1(Be, lq):
    """K2 against its plain version, and bit for bit against K1's kernel:
    the same device functions in the same order."""
    from msmd_tpu_torch.measure import decoder_case
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import decoder_resident as kdr

    args = decoder_case(_card(), Be=Be, lq=lq, L=2, seed=10)
    before = kdr.fused_decoder_forward_resident.launches
    with torch.no_grad():
        got = kdr.fused_decoder_forward_resident(*args)
        k1 = kd.fused_decoder_forward(*args)
        want = kdr.fused_decoder_forward_resident_plain(*args)
    torch.cuda.synchronize()
    assert kdr.fused_decoder_forward_resident.launches == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    print(f"K2 Be={Be} lq={lq} rel_err={_rel(got, want):.3e} max|K2-K1|={float((got - k1).abs().max()):.3e} "
          f"grid={kdr.resident_grid()}")
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, k1)


@pytest.mark.cuda
def test_resident_stamps_follow_its_phases():
    """K2's card-clock stamps: one at the start and one after each phase
    ``resident_phases`` names, in order, at the Hopper-GEMM rows (9 phases
    a layer) and below them (11)."""
    from msmd_tpu_torch.measure import decoder_case
    from msmd_tpu_torch.ops.kernels import decoder_resident as kdr

    for Be, per_layer in ((96, 9), (6, 11)):
        args = decoder_case(_card(), Be=Be, L=2, seed=14)
        stamps = kdr.resident_stamps(*args).cpu()
        names = kdr.resident_phases(Be, 111, 512, 2048, 2)
        assert len(names) == 1 + 2 * per_layer and stamps.numel() == 1 + len(names)
        assert bool((stamps[1:] >= stamps[:-1]).all()) and int(stamps[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", [(1, 37), (100, 37), (130, 37), (4800, 37), (1, 5023), (100, 5023), (130, 5023),
                                 (1040, 5023)])
def test_lbs_kernel_matches_plain(N, V):
    """K5 (3xTF32 on wgmma) at ragged frame and vertex counts, from one
    tile to more tiles than SMs (a block then takes several): within 1e-5 of the f32 plain version (one TF32
    product would miss it), finite, two calls bit-equal, the plan's two
    device kernels a call; the public entry point counts its launch."""
    from msmd_tpu_torch.measure import kernel_events, lbs_case, profiled
    from msmd_tpu_torch.ops.kernels import lbs as kl

    fused, (betas_ext, rt) = lbs_case(_card(), N=N, V=V, seed=3)
    got = kl.skin_cuda(fused, betas_ext, rt)
    want = kl.skin_plain(fused, betas_ext, rt)
    torch.cuda.synchronize()
    print(f"N {N} V {V} tiles {kl.lbs_plan(N, V)['tiles']} max|err| {float((got - want).abs().max()):.3g}")
    assert got.shape == (N, V, 3) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, kl.skin_cuda(fused, betas_ext, rt))
    kernels = [e.name for e in kernel_events(profiled(lambda: kl.skin_cuda(fused, betas_ext, rt))) if "lbs" in e.name]
    assert len(kernels) == kl.lbs_plan(N, V)["launches"], kernels
    before = kl.flame_vertices.launches
    z = torch.zeros(4, 100, device=betas_ext.device)
    verts = kl.flame_vertices(fused, z, z[:, :50], z[:, :6])
    assert kl.flame_vertices.launches == before + 1 and verts.shape == (4, V, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kl.skin_cuda(fused, betas_ext.repeat(1, 2)[:, ::2], rt)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", [(1, 37), (3, 1025), (130, 5023), (1760, 5023)])
def test_lbs_backward_kernel_matches_plain(N, V):
    """K5 bwd against the skinning terms of the plain VJP: dv and d_rt
    within 1e-4 of max |plain| (f32, other summation orders), dv zero past
    V, two calls bit-equal (no atomics), two device kernels a call."""
    from msmd_tpu_torch.measure import kernel_events, lbs_bwd_case, profiled
    from msmd_tpu_torch.ops.kernels import lbs as kl

    fused, betas_ext, rt, planes, g = lbs_bwd_case(_card(), N=N, V=V, seed=6)
    got = kl.skin_vjp_cuda(fused, planes, rt, g)
    want = kl.skin_vjp_plain(fused, planes, rt, g)
    again = kl.skin_vjp_cuda(fused, planes, rt, g)
    torch.cuda.synchronize()
    for name, a, w, c in zip(("dv", "d_rt"), got, want, again):
        rel = float((a - w).abs().max() / w.abs().max())
        print(f"N {N} V {V} {name} max|err|/max|plain| {rel:.3g}")
        assert a.shape == w.shape and bool(torch.isfinite(a).all()) and rel <= 1e-4, name
        assert torch.equal(a, c), name
    assert not got[0][:, :, V:].any()
    kernels = [e.name for e in kernel_events(profiled(lambda: kl.skin_vjp_cuda(fused, planes, rt, g)))
               if "lbs_bwd" in e.name]
    assert len(kernels) == 2, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("ignore_global_rot", [False, True])
def test_flame_vertices_carries_its_gradient(ignore_global_rot):
    """A loss through ``flame_vertices`` (K5 forward, K5 bwd in its VJP) has
    a grad_fn, and its gradients with respect to shape, exp and pose equal
    those through ``flame_vertices_plain`` under torch autograd within 1e-4
    of max |plain|; each wrapper counts its launch."""
    from msmd_tpu_torch.measure import lbs_case
    from msmd_tpu_torch.ops.kernels import lbs as kl

    dev = _card()
    fused, _ = lbs_case(dev, N=1, V=5023, seed=7)
    gen = torch.Generator().manual_seed(8)
    leaves = [(torch.randn(300, n, generator=gen) * s).to(dev).requires_grad_(True)
              for n, s in ((100, 0.3), (50, 0.3), (6, 0.4))]
    target = torch.randn(300, 5023, 3, generator=gen).to(dev) * 0.1
    fwd, bwd = kl.flame_vertices.launches, kl.skin_backward.launches
    loss = ((kl.flame_vertices(fused, *leaves, ignore_global_rot=ignore_global_rot) - target) ** 2).mean()
    assert loss.grad_fn is not None
    got = torch.autograd.grad(loss, leaves)
    assert kl.flame_vertices.launches == fwd + 1 and kl.skin_backward.launches == bwd + 1
    plain = ((kl.flame_vertices_plain(fused, *leaves, ignore_global_rot=ignore_global_rot) - target) ** 2).mean()
    want = torch.autograd.grad(plain, leaves)
    torch.cuda.synchronize()
    for name, a, w in zip(("shape", "exp", "pose"), got, want):
        rel = float((a - w).abs().max() / w.abs().max())
        print(f"d_{name} max|err|/max|plain| {rel:.3g}")
        assert rel <= 1e-4, name
    if ignore_global_rot:
        assert not got[2][:, :3].any()


@pytest.mark.cuda
def test_lbs_stamps_cover_every_block():
    """K5's card-clock stamps: one row a block of the plan's grid, its main
    loops and epilogues within its whole time."""
    from msmd_tpu_torch.measure import lbs_case
    from msmd_tpu_torch.ops.kernels import lbs as kl

    fused, (betas_ext, rt) = lbs_case(_card(), N=300, V=5023, seed=4)
    st = kl.lbs_stamps(fused, betas_ext, rt).cpu()
    plan = kl.lbs_plan(300, 5023, torch.cuda.get_device_properties(0).multi_processor_count)
    assert st.shape == (plan["grid"], 3)
    assert bool((st[:, 0] > 0).all()) and bool((st[:, 1] > 0).all())
    assert bool((st[:, 0] + st[:, 1] <= st[:, 2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("P,N", [(4, 11), (10, 100)])
def test_sampler_kernels_match_plain(P, N):
    """K3 over a short scan to t = 1 and K4 over its step t = 1, where
    x_0 = target, at lq = 16 and 111."""
    from msmd_tpu_torch.measure import sampler_case
    from msmd_tpu_torch.ops.kernels import sampler as ks

    scan, step, kw = sampler_case(_card(), P=P, N=N, L=2, T=6, seed=2)
    before = (ks.fused_sampler_scan.launches, ks.fused_sampler_step.launches)
    with torch.no_grad():
        got_scan, want_scan = ks.fused_sampler_scan(*scan, **kw), ks.fused_sampler_scan_plain(*scan, **kw)
        got_step, want_step = ks.fused_sampler_step(*step, **kw), ks.fused_sampler_step_plain(*step, **kw)
    torch.cuda.synchronize()
    assert (ks.fused_sampler_scan.launches, ks.fused_sampler_step.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((got_scan, want_scan), (got_step, want_step)):
        assert got.shape == want.shape == (N, 67) and bool(torch.isfinite(got).all())
        assert float((got - want).abs().max() / want.abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("t", ["1", "T"])
def test_step_kernel_matches_plain_and_repeats_bit_for_bit(t):
    """K4, one cooperative launch of the small-row stack a step, at the
    flagship shapes (2 layers) at t = 1 (x_0 = target) and at t = T (the
    first step of a window): within 2e-2 of its plain twin, one launch
    counted, and two calls bit-equal."""
    from msmd_tpu_torch.measure import sampler_case
    from msmd_tpu_torch.ops.kernels import sampler as ks

    scan, step, kw = sampler_case(_card(), L=2, T=6, seed=5)
    if t == "T":
        pack, kmem, vmem, motion, emb, sc, z, const = scan
        step = (pack, kmem, vmem, motion, emb[0], sc[0], z[0], step[7])
    before = ks.fused_sampler_step.launches
    with torch.no_grad():
        got, again = ks.fused_sampler_step(*step, **kw), ks.fused_sampler_step(*step, **kw)
        want = ks.fused_sampler_step_plain(*step, **kw)
    torch.cuda.synchronize()
    assert ks.fused_sampler_step.launches == before + 2
    print(f"K4 t={t} rel_err={_rel(got, want):.3e}")
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_sampler_wrappers_refuse_what_the_kernels_do_not_take():
    from msmd_tpu_torch.measure import sampler_case
    from msmd_tpu_torch.ops.kernels import sampler as ks

    scan, step, kw = sampler_case(_card(), P=4, N=11, L=1, T=2)
    pack, kmem, vmem, motion, emb, sc, z, const = scan
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        ks.fused_sampler_scan({**pack, "wf1": pack["wf1"].float()}, *scan[1:], **kw)
    with pytest.raises(TypeError, match="must be torch.float32"):
        ks.fused_sampler_scan(pack, kmem, vmem, motion, emb, sc, z, {**const, "vmw": const["vmw"].bfloat16()}, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ks.fused_sampler_scan(pack, kmem, vmem, motion, emb, sc, z.transpose(1, 2).contiguous().transpose(1, 2),
                              const, **kw)
    with pytest.raises(ValueError, match="shape"):
        ks.fused_sampler_step(*step[:4], emb, *step[5:], **kw)
    with pytest.raises(ValueError, match="must be on"):
        ks.fused_sampler_step(step[0], step[1].cpu(), *step[2:], **kw)


def _small_stack_calls(dev, which, grid=0):
    """(kernel call, plain call) of K3 (a 6-step scan to t = 1), of K4 (its
    step t = 1) or of K1's flat mode in one cross form, at lq = 111 with
    the flagship widths and 2 layers. ``grid`` 0 calls the wrapper (every block the card holds);
    otherwise its launch helper on that many blocks."""
    from msmd_tpu_torch.measure import decoder_flat_case, sampler_case
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import sampler as ks

    if which == "step":
        _, step, kw = sampler_case(dev, L=2, T=6, seed=4)
        plain = lambda: ks.fused_sampler_step_plain(*step, **kw)
        if not grid:
            return (lambda: ks.fused_sampler_step(*step, **kw)), plain
        args = (*step, kw["n_heads"], kw["n_entries"], kw["n_cur"], kw["d_motion"], kw["num_basis"],
                kw["use_indicator"], kw["sigmoid_alpha"], kw["coefficients"], 1)
        return (lambda: ks._launch("msmd_sampler_step", *args, _grid_blocks=grid)), plain
    if which == "scan":
        scan, _, kw = sampler_case(dev, L=2, T=6, seed=4)
        plain = lambda: ks.fused_sampler_scan_plain(*scan, **kw)
        if not grid:
            return (lambda: ks.fused_sampler_scan(*scan, **kw)), plain
        args = (*scan, kw["n_heads"], kw["n_entries"], kw["n_cur"], kw["d_motion"], kw["num_basis"],
                kw["use_indicator"], kw["sigmoid_alpha"], kw["coefficients"], scan[6].shape[0])
        return (lambda: ks._launch("msmd_sampler_scan", *args, _grid_blocks=grid)), plain
    Be, width = (4, 1) if which == "flat_band" else (2, 0)
    args = decoder_flat_case(dev, Be=Be, width=width, L=2, seed=12)
    plain = lambda: kd.fused_decoder_forward_plain(*args)
    if not grid:
        return (lambda: kd.fused_decoder_forward_flat(*args)), plain
    return (lambda: kd._launch_flat(*args, _grid_blocks=grid)), plain


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["scan", "step", "flat_band", "flat_full"])
@pytest.mark.parametrize("grid", [0, 40])
def test_small_stack_kernels_match_plain_and_repeat_bit_for_bit(which, grid):
    """K3, K4 and K1's flat mode on the persistent small-row stack, on every
    block the card holds (0) and on 40: within 2e-2 of the plain twin, and
    two calls give the same bits (split-K partials summed in slot order, no
    float atomics)."""
    call, plain = _small_stack_calls(_card(), which, grid)
    with torch.no_grad():
        got, again, want = call(), call(), plain()
    torch.cuda.synchronize()
    print(f"small stack {which} grid={grid} rel_err={_rel(got, want):.3e}")
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("Be,lq,L,mode", [(2, 111, 8, "entry"), (4, 111, 8, "flat_band"), (2, 111, 8, "flat_full"),
                                          (6, 37, 2, "flat_full"), (2, 16, 2, "entry"), (2, 111, 8, "entry_gather"),
                                          (2, 16, 2, "entry_gather")])
def test_small_stack_plan_matches_the_library(Be, lq, L, mode):
    """The C plans (``msmd_scan_plan``, ``msmd_step_plan``,
    ``msmd_flat_plan``) equal ``small_stack_plan`` at the card's SM count
    and occupancy."""
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import sampler as ks
    from msmd_tpu_torch.ops.kernels import small_stack as ss

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = 3 if Be == 6 else Be
    if mode.startswith("entry"):
        n_cur = lq - 11
        c = ks.scan_plan(lq, 512, 8, L, 2048, n_cur, 67, 4, 256, True, n_entries=Be, step=mode == "entry_gather")
        py = ss.small_stack_plan(Be, lq, 512, 2048, 8, mode, sms=sms, per_sm=c["per_sm"], L=L, n_cur=n_cur, Fd=256)
    else:
        c = kd.flat_plan(Be, lq, 512, 8, L, 2048, tile, mode == "flat_band")
        py = ss.small_stack_plan(Be, lq, 512, 2048, 8, mode, sms=sms, per_sm=c["per_sm"], L=L, tile=tile)
    assert c["per_sm"] >= 1 and c["grid"] == c["per_sm"] * sms == py["grid"]
    assert c["smem"] == py["smem"] == ss.SMALL_SMEM
    assert c["rows"] == ss.plan_rows(py)


@pytest.mark.cuda
def test_small_stack_wrappers_refuse_a_grid_that_cannot_be_resident():
    dev = _card()
    for which in ("scan", "step", "flat_band"):
        with pytest.raises(RuntimeError, match="cooperative|too large|fits"):
            _small_stack_calls(dev, which, 100000)[0]()
        _small_stack_calls(dev, which)[0]()  # the card's own grid still runs
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_small_stack_wrappers_refuse_unsupported_shapes():
    from msmd_tpu_torch.measure import decoder_flat_case, sampler_case
    from msmd_tpu_torch.ops.kernels import decoder as kd
    from msmd_tpu_torch.ops.kernels import sampler as ks

    dev = _card()
    args = decoder_flat_case(dev, Be=2, lq=129, width=0, L=1, seed=1)
    with pytest.raises(ValueError, match="lq"):
        kd.fused_decoder_forward_flat(*args)
    scan, _, kw = sampler_case(dev, P=4, N=11, F=256, H=2, L=1, FF=512, T=2)
    with pytest.raises(ValueError, match="head dim"):
        ks.fused_sampler_scan(*scan, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,F,FF", [(100, 128, 256), (1776, 512, 2048)])
def test_ffn_train_kernels_match_plain(rows, F, FF):
    """K7 forward and backward against their plain versions, at a ragged
    row count and at the train step's shapes."""
    from msmd_tpu_torch.measure import ffn_train_case
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    args, gbar = ffn_train_case(_card(), rows=rows, F=F, FF=FF, seed=4)
    before = (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches)
    got = [k7.ffn_train_forward(*args)] + list(k7.ffn_train_backward(args[0], gbar, *args[1:]))
    want = [k7.ffn_train_forward_plain(*args)] + list(k7.ffn_train_backward_plain(args[0], gbar, *args[1:]))
    torch.cuda.synchronize()
    assert (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches) == (before[0] + 1, before[1] + 1)
    for name, a, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2", "dg", "db"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype and bool(torch.isfinite(a).all()), name
        assert float((a.float() - w.float()).abs().max() / w.float().abs().max()) <= 2e-2, name


@pytest.mark.cuda
def test_ffn_train_mask_bits_match_plain():
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    dev = _card()
    seed = k7.seed_tensor(987654321, dev)
    for salt, rows, cols in ((1, 37, 2048), (2, 1776, 512)):
        got = k7.kernel_mask_bits(seed, salt, rows, cols)
        assert int((got != k7.philox_bits(seed, salt, rows, cols, dev)).sum()) == 0


@pytest.mark.cuda
def test_ffn_train_function_on_the_card():
    """The autograd Function launches one forward and one backward kernel
    and returns a gradient for every input in its dtype."""
    from msmd_tpu_torch.measure import ffn_train_case
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    args, gbar = ffn_train_case(_card(), rows=222, F=512, FF=2048, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in args[:7]]
    before = (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches)
    out = k7.fused_ffn_ln_train(*leaves, args[7], args[8])
    grads = torch.autograd.grad(out, leaves, gbar)
    torch.cuda.synchronize()
    assert (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches) == (before[0] + 1, before[1] + 1)
    assert [g.dtype for g in grads] == [t.dtype for t in leaves]
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        k7.ffn_train_forward(args[0], args[1].float(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        k7.ffn_train_forward(args[0].t().contiguous().t(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,p", [(1776, 0.1), (1776, 0.0), (1777, 0.1), (1777, 0.0), (1040, 0.1)])
def test_ffn_train_wgmma_route_matches_plain_and_repeats_bit_for_bit(rows, p):
    """K7 on the wgmma route (``csrc/gemm_train.cuh``) at the train step's
    shapes, one row past them (a ragged last row block and a ragged last
    k-step of the weight gradients) and a few row blocks past the route's
    threshold, with and without dropout: out and the seven gradients
    against the plain versions, and two calls equal bit for bit."""
    from msmd_tpu_torch.measure import ffn_train_case
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    args, gbar = ffn_train_case(_card(), rows=rows, F=512, FF=2048, p=p, seed=7)
    assert k7.ffn_train_plan(rows, 512, 2048, True)["route"] == "wgmma"
    before = (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches)
    got = [k7.ffn_train_forward(*args)] + list(k7.ffn_train_backward(args[0], gbar, *args[1:]))
    again = [k7.ffn_train_forward(*args)] + list(k7.ffn_train_backward(args[0], gbar, *args[1:]))
    want = [k7.ffn_train_forward_plain(*args)] + list(k7.ffn_train_backward_plain(args[0], gbar, *args[1:]))
    torch.cuda.synchronize()
    assert (k7.ffn_train_forward.launches, k7.ffn_train_backward.launches) == (before[0] + 2, before[1] + 2)
    for name, a, b, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2", "dg", "db"), got, again, want):
        assert a.shape == w.shape and a.dtype == w.dtype and bool(torch.isfinite(a).all()), name
        print(f"K7 rows={rows} p={p} {name} rel_err={_rel(a, w):.3e}")
        assert _rel(a, w) <= 2e-2, name
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("rows,F,FF", [(1776, 512, 2048), (1777, 512, 2048), (1040, 512, 2048), (1023, 512, 2048),
                                       (100, 128, 256), (1776, 256, 1024), (1776, 512, 1024)])
@pytest.mark.parametrize("backward", [False, True])
def test_ffn_train_plan_matches_the_library(rows, F, FF, backward):
    """K7's pure-Python plan equals what the library launches on this card
    (route, launches, row chunks of the weight gradients, each launch's
    grid)."""
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    _card()
    plan = k7.ffn_train_plan(rows, F, FF, backward)
    assert k7.kernel_plan(rows, F, FF, backward) == {k: plan[k] for k in ("route", "launches", "row_chunks", "grids")}


@pytest.mark.cuda
@pytest.mark.parametrize("rows,F,FF,route", [(1776, 512, 2048, "wgmma"), (100, 128, 256, "wmma")])
def test_ffn_train_launches_per_call(rows, F, FF, route):
    """One forward and one backward call run the plan's launches on the
    card (device kernels in torch.profiler): 2 and 6 on the wgmma route,
    3 and 15 on the wmma chain that the small shapes keep."""
    from msmd_tpu_torch.measure import ffn_train_case, kernel_events, profiled
    from msmd_tpu_torch.ops.kernels import ffn_train as k7

    args, gbar = ffn_train_case(_card(), rows=rows, F=F, FF=FF, seed=8)
    for backward, call in ((False, lambda: k7.ffn_train_forward(*args)),
                           (True, lambda: k7.ffn_train_backward(args[0], gbar, *args[1:]))):
        plan = k7.ffn_train_plan(rows, F, FF, backward)
        assert plan["route"] == route
        call()
        kernels = [e.name for e in kernel_events(profiled(call))]
        assert len(kernels) == plan["launches"], kernels
        if route == "wgmma":
            assert all("gemm_train_kernel" in n or "ffn_reduce_kernel" in n for n in kernels), kernels


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,F,FF,route", [(100, 128, 256, "wmma"), (96 * 111, 512, 2048, "wgmma_ws"),
                                             (1887, 512, 2048, "wgmma_ws"), (96 * 111 + 1, 512, 2048, "wgmma_ws")])
def test_ffn_kernel_matches_plain(rows, F, FF, route):
    """K6 at a row count that no GEMM tile divides (the wmma route), at the
    guided batch-48 shape, at 17 entries of 111 rows (fewer row blocks than
    SM pairs) and one row past the guided shape (a last row block whose
    second half lies wholly past the rows), the last three on the
    warp-specialized GEMM; with its weights' tensor maps made once
    (``prepare_ffn_weights``) and made in the call."""
    from msmd_tpu_torch.measure import ffn_case
    from msmd_tpu_torch.ops.kernels import ffn as k6

    args = ffn_case(_card(), rows=rows, F=F, FF=FF, seed=6)
    assert {p["plan"]["route"] for p in k6.ffn_products(rows, F, FF).values()} == {route}
    prepared = k6.prepare_ffn_weights(*args[1:], dtype=torch.bfloat16)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(prepared[:6], args[1:]))  # bf16 already: no copies
    before = k6.fused_ffn_ln.launches
    got, want = k6.fused_ffn_ln(*args), k6.ffn_ln_plain(*args)
    got_prepared = k6.fused_ffn_ln(args[0], *prepared)
    torch.cuda.synchronize()
    assert k6.fused_ffn_ln.launches == before + 2
    assert got.shape == want.shape == (rows, F) and got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    print(f"K6 rows={rows} route={route} rel_err={_rel(got, want):.3e}")
    assert _rel(got, want) <= 2e-2
    assert torch.equal(got_prepared, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,lq", [(3, 16), (5, 37), (96, 111)])
def test_attn_kernel_matches_plain(B, lq):
    """K8 on the column slices of one fused q/k/v projection, at row counts
    that are not multiples of 16 and at the guided batch-48 shape."""
    from msmd_tpu_torch.measure import attn_case
    from msmd_tpu_torch.ops.kernels import attn as k8

    q, k, v, H = attn_case(_card(), B=B, lq=lq, seed=7)
    before = k8.attention_middle.launches
    got, want = k8.attention_middle(q, k, v, H), k8.attention_middle_plain(q, k, v, H)
    torch.cuda.synchronize()
    assert k8.attention_middle.launches == before + 1
    assert got.shape == want.shape == q.shape and got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    print(f"K8 B={B} lq={lq} rel_err={_rel(got, want):.3e}")
    assert _rel(got, want) <= 2e-2
    contiguous = k8.attention_middle(q.contiguous(), k.contiguous(), v.contiguous(), H)
    assert torch.equal(contiguous, got)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 96])
@pytest.mark.parametrize("lq", [1, 15, 16, 17, 64, 111, 128])
def test_attn_kernel_at_lq_edges(lq, B):
    """K8 at the edges of its 16-row warp tiles (one row, a tile short by
    one, whole tiles, one past) and at the guided shape, one entry and 96;
    its shared memory as ``attn_plan`` gives it."""
    from msmd_tpu_torch.measure import attn_case
    from msmd_tpu_torch.ops.kernels import attn as k8

    q, k, v, H = attn_case(_card(), B=B, lq=lq, seed=13)
    got, want = k8.attention_middle(q, k, v, H), k8.attention_middle_plain(q, k, v, H)
    torch.cuda.synchronize()
    assert k8._lib().msmd_attn_smem_bytes(lq) == k8.attn_plan(B, lq, H)["smem"]
    assert got.shape == want.shape == q.shape and bool(torch.isfinite(got.float()).all())
    print(f"K8 B={B} lq={lq} rel_err={_rel(got, want):.3e}")
    assert _rel(got, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("Be,lm,F,FF,route", [(3, 15, 128, 256, "wmma"), (96, 110, 512, 2048, "wgmma_ws"),
                                              (17, 111, 512, 2048, "wgmma_ws")])
def test_layer_tail_kernel_matches_plain(Be, lm, F, FF, route):
    """K9 on the wmma route, at the guided batch-48 shape and at 17 entries
    of 111 rows on the warp-specialized GEMM; with its weights' tensor maps
    made once (``prepare_tail_weights``) and made in the call."""
    from msmd_tpu_torch.measure import tail_case
    from msmd_tpu_torch.ops.kernels import layer_tail as k9

    args = tail_case(_card(), Be=Be, lm=lm, F=F, FF=FF, seed=8)
    assert {p["plan"]["route"] for p in k9.tail_products(Be * lm, F, FF).values()} == {route}
    ln_s, ln_b = args[11], args[12]
    prepared = k9.prepare_tail_weights(*args[3:11], list(ln_s), list(ln_b), dtype=torch.bfloat16)
    assert torch.equal(prepared.ln_scale, ln_s) and torch.equal(prepared.ln_bias, ln_b)
    before = k9.fused_layer_tail.launches
    got, want = k9.fused_layer_tail(*args), k9.layer_tail_plain(*args)
    got_prepared = k9.fused_layer_tail(*args[:3], *prepared)
    torch.cuda.synchronize()
    assert k9.fused_layer_tail.launches == before + 2
    assert got.shape == want.shape == (Be, lm, F) and got.dtype == torch.bfloat16
    print(f"K9 rows={Be * lm} route={route} rel_err={_rel(got, want):.3e}")
    assert bool(torch.isfinite(got).all()) and _rel(got, want) <= 2e-2
    assert torch.equal(got_prepared, got)


# K6's and K9's products at the guided batch-48 shapes (10656 and 10560
# rows) and at 17 entries of 111 rows: (M, N, K, epilogue, residual dtype, output)
GUIDED_PRODUCTS = [
    (10656, 2048, 512, "gelu", None, "bf16"), (10656, 512, 2048, "resid_ln", torch.bfloat16, "bf16"),
    (10560, 512, 512, "resid_ln", torch.bfloat16, "x"), (10560, 512, 512, "resid_ln", torch.float32, "x_xb"),
    (10560, 2048, 512, "gelu_erf", None, "bf16"), (10560, 512, 2048, "resid_ln", torch.float32, "bf16"),
    (1887, 2048, 512, "gelu_erf", None, "bf16"), (1887, 512, 2048, "resid_ln", torch.float32, "x_xb"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,epilogue,res_dtype,out", GUIDED_PRODUCTS)
def test_gemm_ws_product_matches_plain(M, N, K, epilogue, res_dtype, out):
    """Each product of K6 and K9 alone on the warp-specialized GEMM against
    its plain version (the same bf16 operands, f32 sums), and on the wmma
    route within the same bound."""
    from msmd_tpu_torch.measure import gemm_ws_case
    from msmd_tpu_torch.ops.kernels import gemm_ws as kw

    args, kwargs = gemm_ws_case(_card(), M, N, K, epilogue, res_dtype, out, seed=14)
    before = kw.gemm_ws.launches
    got = kw.gemm_ws(*args, epilogue, route="wgmma_ws", **kwargs)
    auto = kw.gemm_ws(*args, epilogue, **kwargs)
    old = kw.gemm_ws(*args, epilogue, route="wmma", **kwargs)
    want = kw.gemm_ws_plain(*args, epilogue, **kwargs)
    torch.cuda.synchronize()
    assert kw.gemm_ws.launches == before + 3
    if out == "x_xb":
        (got, got_b), (auto, _), (old, _), (want, want_b) = got, auto, old, want
        assert got.dtype == torch.float32 and got_b.dtype == torch.bfloat16 and _rel(got_b, want_b) <= 2e-2
    assert got.dtype == (torch.float32 if out != "bf16" else torch.bfloat16)
    assert got.shape == (M, N) and torch.equal(got, auto) and bool(torch.isfinite(got.float()).all())
    print(f"gemm_ws {M}x{N}x{K} {epilogue} res={res_dtype} out={out} rel_err={_rel(got, want):.3e} "
          f"wmma={_rel(old, want):.3e}")
    assert _rel(got, want) <= 2e-2 and _rel(old, want) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,epilogue", [(10656, 2048, 512, "gelu"), (10656, 512, 2048, "resid_ln"),
                                            (10560, 512, 512, "resid_ln"), (1887, 2048, 512, "gelu_erf"),
                                            (1023, 512, 512, "resid_ln"), (100, 256, 128, "gelu"),
                                            (10656, 384, 512, "resid_ln"), (10656, 640, 512, "gelu")])
def test_gemm_ws_plan_matches_the_library(M, N, K, epilogue):
    """The pure-Python launch plan of K6's and K9's products equals what
    the library launches on this card (route, tile, cluster, tiles, grid,
    shared memory)."""
    from msmd_tpu_torch.ops.kernels import gemm_ws as kw

    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert kw.kernel_plan(M, N, K, epilogue) == kw.gemm_ws_plan(M, N, K, epilogue, sms=sms)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("lq", [1, 100, 128, 129, 256])
def test_attn_f32_kernel_matches_plain(lq, B):
    """K8's f32 mode (the style encoders' attention at inference) at one
    row, the 100-frame clip, the CTA edges 128 / 129 and ``MAX_LQ``: f32
    ``attention_middle`` launches it (counted apart from the bf16 mode), max
    |err| <= 1e-5 of max |plain| (the plain version at f32 with TF32 off;
    other f32 summation orders and 3xTF32 products), two calls bit-equal,
    the library's plan query (grid, CTAs a head, threads, query rows, key
    tiles, shared memory) as ``attn_f32_plan`` gives it."""
    import ctypes

    from msmd_tpu_torch.measure import attn_case
    from msmd_tpu_torch.ops.kernels import attn as k8

    q, k, v, H = attn_case(_card(), B=B, lq=lq, seed=17, dtype=torch.float32)
    before, before_bf16 = k8.attention_middle_f32.launches, k8.attention_middle.launches
    got, again = k8.attention_middle(q, k, v, H), k8.attention_middle(q, k, v, H)
    want = k8.attention_middle_plain(q, k, v, H)
    torch.cuda.synchronize()
    assert k8.attention_middle_f32.launches == before + 2 and k8.attention_middle.launches == before_bf16
    plan, lib_plan = k8.attn_f32_plan(B, lq, H), (ctypes.c_long * 6)()
    assert k8._lib().msmd_attn_f32_plan(B, lq, H, lib_plan) == 0
    assert list(lib_plan) == [plan[key] for key in ("grid", "ctas_per_head", "threads", "query_rows", "nc", "smem")]
    assert got.shape == want.shape == q.shape and got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    print(f"K8 f32 B={B} lq={lq} rel_err={_rel(got, want):.3e}")
    assert _rel(got, want) <= 1e-5
    assert torch.equal(got, again)
    assert torch.equal(k8.attention_middle(q.contiguous(), k.contiguous(), v.contiguous(), H), got)


@pytest.mark.cuda
def test_attn_kernel_gate_routes_rows_past_max_lq():
    """An encoder layer with ``attn_kernel`` at f32: K8's f32 mode at
    ``MAX_LQ`` rows (once, within 1e-5 of the plain route), and past it the
    plain attention by ``attn_kernel_takes`` (no launch); the wrapper
    itself refuses such rows."""
    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.transformer import TransformerEncoderLayer
    from msmd_tpu_torch.ops.kernels import attn as k8

    dev = _card()
    layer = init_params(TransformerEncoderLayer(512, 8, 512), 3).to(dev).eval()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lq, launched in ((k8.MAX_LQ, 1), (k8.MAX_LQ + 1, 0)):
            x = torch.randn(2, lq, 512, generator=g).to(dev)
            before = k8.attention_middle_f32.launches
            got, want = layer(x, attn_kernel=True), layer(x)
            torch.cuda.synchronize()
            assert k8.attention_middle_f32.launches == before + launched
            assert _rel(got, want) <= 1e-5
        with pytest.raises(ValueError, match="lq=257"):
            k8.attention_middle_f32(x, x, x, 8)


@pytest.mark.cuda
def test_guided_wrappers_refuse_what_the_kernels_do_not_take():
    from msmd_tpu_torch.measure import attn_case, ffn_case, tail_case
    from msmd_tpu_torch.ops.kernels import attn as k8
    from msmd_tpu_torch.ops.kernels import ffn as k6
    from msmd_tpu_torch.ops.kernels import layer_tail as k9

    dev = _card()
    x, w1, *rest = ffn_case(dev, rows=10, F=128, FF=256)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        k6.fused_ffn_ln(x.float(), w1, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        k6.fused_ffn_ln(x, w1.t().contiguous().t(), *rest)
    with pytest.raises(ValueError, match="shape"):
        k6.fused_ffn_ln(x, w1[:128], *rest)
    q, k, v, H = attn_case(dev, B=2, lq=16)
    with pytest.raises(ValueError, match="head dim 64"):
        k8.attention_middle(q, k, v, 4)
    with pytest.raises(ValueError, match="row stride"):
        k8.attention_middle(q.contiguous(), k, v, H)
    with pytest.raises(ValueError, match="lq=400"):
        big = torch.zeros(1, 400, 512, dtype=torch.bfloat16, device=dev)
        k8.attention_middle(big, big, big, 8)
    args = list(tail_case(dev, Be=2, lm=5, F=128, FF=256))
    with pytest.raises(TypeError, match="must be torch.float32"):
        k9.fused_layer_tail(*args[:11], args[11].bfloat16(), args[12])
    with pytest.raises(ValueError, match="must be on"):
        k9.fused_layer_tail(args[0], args[1], args[2].cpu(), *args[3:])


@pytest.mark.cuda
def test_gemm_ws_wrapper_refuses_what_the_kernel_does_not_take():
    from msmd_tpu_torch.measure import ffn_case, gemm_ws_case
    from msmd_tpu_torch.ops.kernels import ffn as k6
    from msmd_tpu_torch.ops.kernels import gemm_ws as kw

    dev = _card()
    args, kwargs = gemm_ws_case(dev, 222, 512, 512, "resid_ln", torch.float32, "bf16")
    with pytest.raises(ValueError, match="does not take M=222"):
        kw.gemm_ws(*args, "resid_ln", route="wgmma_ws", **kwargs)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        kw.gemm_ws(args[0], args[1].float(), args[2], "resid_ln", **kwargs)
    with pytest.raises(ValueError, match="shape"):
        kw.gemm_ws(args[0], args[1][:, :256].contiguous(), args[2], "resid_ln", **kwargs)
    with pytest.raises(TypeError, match="needs res"):
        kw.gemm_ws(*args, "resid_ln", **{**kwargs, "res": kwargs["res"].double()})
    with pytest.raises(ValueError, match="unknown route"):
        kw.gemm_ws(*args, "resid_ln", route="cublas", **kwargs)
    x, w1, b1, w2, b2, g, b = ffn_case(dev, rows=1100, F=512, FF=2048)
    other = k6.prepare_ffn_weights(w1.clone(), b1, w2, b2, g, b, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not those the maps were made for"):
        k6.fused_ffn_ln(x, w1, b1, w2, b2, g, b, other.maps)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused_ffn", "fused_tail"])
def test_guided_layer_call_launches_no_weight_cast(route):
    """A bf16 decoder layer at the guided batch-48 shapes, converted to bf16
    as ``sample`` converts the denoiser: once its K6 (or K9) weights are
    prepared, a layer call casts, detaches and stacks none of the kernel's
    parameters for the kernel (every ``Tensor.to``, ``Tensor.float``,
    ``Tensor.detach`` and ``torch.stack`` call that makes a new tensor is
    seen; K9's person rows run the plain LayerNorm modules, which cast
    their six parameters to f32 as on every route) and reuses the prepared
    tensors; a parameter changed in place makes them again; a deep copy of
    the layer starts without them."""
    import copy

    from torch.overrides import TorchFunctionMode

    from msmd_tpu_torch.models.layers import init_params
    from msmd_tpu_torch.models.transformer import TransformerDecoderLayer

    dev = _card()
    F, FF, Be, lq = 512, 2048, 96, 111
    layer = init_params(TransformerDecoderLayer(F, 8, FF, dtype=torch.bfloat16), 3).to(dev, torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(Be, lq, F, generator=g).to(dev, torch.bfloat16)
    kv = layer.memory_kv(torch.randn(Be, lq - 1, F, generator=g).to(dev))
    kw = dict(memory_kv=kv, cross_identity_band=True, **{route: True})
    l1, l2 = layer.ffn.linear1, layer.ffn.linear2
    owned = [l1.weight, l1.bias, l2.weight, l2.bias, layer.norm3.weight, layer.norm3.bias]
    if route == "fused_tail":
        owned += [layer.self_attn.out_proj.weight, layer.self_attn.out_proj.bias, layer.cross_attn.out_proj.weight,
                  layer.cross_attn.out_proj.bias, layer.norm1.weight, layer.norm1.bias, layer.norm2.weight,
                  layer.norm2.bias]
    owned_ids = {id(p) for p in owned}

    class Casts(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in (torch.Tensor.to, torch.Tensor.float, torch.Tensor.detach, torch.stack):
                flat = list(args[0]) if func is torch.stack else [args[0]]
                self.seen += [func.__name__ for t in flat if id(t) in owned_ids and out is not t]
            return out

    with torch.no_grad():
        first = layer(x, **kw)
        prepared = dict(layer._kernel_weights)
        with Casts() as casts:
            second = layer(x, **kw)
        torch.cuda.synchronize()
    assert torch.equal(first, second) and prepared
    assert all(layer._kernel_weights[k][1] is v[1] for k, v in prepared.items())
    assert casts.seen == (["float"] * 6 if route == "fused_tail" else [])
    with torch.no_grad():
        twin = copy.deepcopy(layer)  # as sample() copies the denoiser: the tensor maps stay behind
        assert twin._kernel_weights == {} and torch.equal(twin(x, **kw), first)
        l1.weight.mul_(1.0)
        with Casts() as casts:
            layer(x, **kw)
    name = "k6" if route == "fused_ffn" else "k9"
    assert layer._kernel_weights[name][1] is not prepared[name][1] and casts.seen


@pytest.mark.cuda
def test_nccl_world_size_one_step_is_bit_equal(tmp_path):
    """Three train steps of the trainer on a data-parallel layout under
    NCCL at world size 1 (its gradient all-reduce over a group of one)
    equal the one-process trainer's, losses and parameters bit for bit
    (in a process of its own, in PyTorch's deterministic mode)."""
    from msmd_tpu_torch.parallel.mesh import spawn

    import torch_parallel_workers as W

    _card()
    out = spawn(W.nccl_world1, 1, "nccl", str(tmp_path / "store"), (str(tmp_path), 3), timeout=600)[0]
    assert out["distributed"] and out["losses"][0] == out["losses"][1]
    assert out["params_bit_equal"] and all(torch.isfinite(torch.tensor(out["losses"][0])))


@pytest.mark.cuda
def test_safetensors_reader_on_the_card(tmp_path):
    from msmd_tpu_torch.hf_loader import read_safetensors, write_safetensors

    dev = _card()
    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(768, 3072, generator=g), "b": torch.randn(3072, generator=g).to(torch.bfloat16),
               "i": torch.arange(10, dtype=torch.int64)}
    write_safetensors(tmp_path / "m.safetensors", tensors)
    got = read_safetensors(tmp_path / "m.safetensors", device=dev)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype and torch.equal(got[k].cpu(), v), k


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 100, 67, 512, 1), (32, 200, 768, 768, 16)])
def test_conv_backward_is_bit_equal_across_calls(shape):
    """The port's Conv1d takes cuDNN's deterministic backward: the style
    encoder's first convolution (67 -> 512, batch 2B = 32 of a train step)
    and HuBERT's grouped positional one give the same gradients twice."""
    from msmd_tpu_torch.models.layers import Conv1d

    dev = _card()
    B, L, cin, cout, groups = shape
    conv = Conv1d(cin, cout, 3, padding=1, groups=groups).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, L, cin, device=dev, generator=g)
    gy = torch.randn(B, L, cout, device=dev, generator=g)
    grads = []
    for _ in range(3):
        xr = x.clone().requires_grad_(True)
        conv.zero_grad(set_to_none=True)
        conv(xr).backward(gy)
        grads.append((xr.grad.clone(), conv.weight.grad.clone()))
    torch.cuda.synchronize()
    assert all(torch.equal(a[0], grads[0][0]) and torch.equal(a[1], grads[0][1]) for a in grads[1:])


@pytest.mark.cuda
def test_audio_encoder_span_holds_its_launches_on_the_kernels_clock():
    """One profiled ``extract_audio_feature`` call at the flagship's
    widths: every kernel, copy and fill of the session has its runtime
    call (by correlation id) inside the ``msmd.audio_encoder`` span, and
    starts on the device no earlier than the span: the span and the
    device records share one clock. (A device record may lead its own
    launch call by a few microseconds, the clocks' conversion: not
    asserted.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from msmd_tpu_torch.config import AudioEncoderConfig, MSMDConfig
    from msmd_tpu_torch.models.diffusion import MSMD

    dev = _card()
    with torch.device(dev):
        model = MSMD(MSMDConfig(), audio_config=AudioEncoderConfig(), dtype=torch.bfloat16).eval()
    audio = torch.randn(2, 64000, device=dev)
    with torch.no_grad():
        model.extract_audio_feature(audio)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.extract_audio_feature(audio)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    (s0, s1), = [(e.start_ns(), e.end_ns()) for e in host if e.name() == "msmd.audio_encoder"]
    calls = {e.correlation_id(): e.start_ns() for e in host if e.name().startswith("cu")}
    device = [(e.correlation_id(), e.start_ns()) for e in events
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert len(device) > 10 and all(c in calls for c, _ in device)
    assert all(s0 <= calls[c] < s1 and start >= s0 for c, start in device)


def _k10_case(dev, B, L, H=16, D=64, seed=10):
    """K10's inputs: q, k, v, dout bf16 N(0, 1), the gate in (1, 3), the
    table N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(B, L, H, D, generator=gen).to(dev, torch.bfloat16) for _ in range(4))
    g = (1 + 2 * torch.rand(B, H, L, generator=gen)).to(dev)
    r = torch.randn(H, 2 * L - 1, generator=gen).to(dev)
    return q, k, v, g, r, dout


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(32, 200), (1, 400), (3, 1), (2, 65), (1, 2048)])
def test_relpos_kernel_matches_plain_and_repeats_bit_for_bit(B, L):
    """K10 (forward, and backward from the forward's out and log-sum-exp)
    against its plain twin on the same inputs: the output, dq, dk and dv
    within 2e-2 of max |plain| (bf16 P and dS in the products, as the
    kernel rounds them), the log-sum-exp within 1e-5 of max |plain|, dg and
    dr within 1e-3 (f32 sums of the same f32 dS in other orders); two calls
    bit-equal (no atomics); one launch counted a call each way."""
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra

    q, k, v, g, r, dout = _k10_case(_card(), B, L)
    fwd0, bwd0 = ra.relpos_attention_cuda.launches, ra.relpos_attention_bwd_cuda.launches
    out, lse = ra.relpos_attention_cuda(q, k, v, g, r)
    want_out, want_lse = ra.relpos_attention_fwd_plain(q, k, v, g, r)
    grads = ra.relpos_attention_bwd_cuda(q, k, v, g, r, out, lse, dout)
    want = ra.relpos_attention_bwd_plain(q, k, v, g, r, out, lse, dout)
    again = (ra.relpos_attention_cuda(q, k, v, g, r), ra.relpos_attention_bwd_cuda(q, k, v, g, r, out, lse, dout))
    torch.cuda.synchronize()
    tol = {"out": 2e-2, "lse": 1e-5, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2, "dg": 1e-3, "dr": 1e-3}
    got_all = (out, lse) + tuple(grads)
    want_all = (want_out, want_lse) + tuple(want)
    # dq, dk, dg and dr are nought at L = 1 (one key: dS is round-off), so there both sides hold round-off:
    # measured against what dS's size would give, dv's (times r's for dg, g's and B for dr)
    dv = float(want[2].float().abs().max())
    floor = {"dq": 1e-3 * dv, "dk": 1e-3 * dv, "dg": 1e-3 * dv * float(r.abs().max()),
             "dr": 1e-3 * dv * float(g.abs().max()) * B}
    for name, a, w in zip(tol, got_all, want_all):
        err = float((a.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), floor.get(name, 1e-30))
        print(f"B {B} L {L} {name} max|err|/max|plain| {err:.3g}")
        assert a.shape == w.shape and a.dtype == w.dtype and bool(torch.isfinite(a).all()), name
        assert err <= tol[name], name
    for a, c in zip(got_all, again[0] + tuple(again[1])):
        assert torch.equal(a, c)
    assert ra.relpos_attention_cuda.launches - fwd0 == 2 and ra.relpos_attention_bwd_cuda.launches - bwd0 == 2


@pytest.mark.cuda
def test_relpos_wrapper_refuses_what_its_gate_refuses():
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra

    dev = _card()
    q, k, v, g, r, _ = _k10_case(dev, 1, 8)
    with pytest.raises(ValueError):
        ra.relpos_attention_cuda(q.float(), k.float(), v.float(), g, r)
    narrow = q[..., :32].contiguous()
    with pytest.raises(ValueError):
        ra.relpos_attention_cuda(narrow, narrow, narrow, g, r)
    L = ra.MAX_L + 1
    long = torch.zeros(1, L, 1, 64, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        ra.relpos_attention_cuda(long, long, long, torch.zeros(1, 1, L, device=dev), torch.zeros(1, 2 * L - 1,
                                                                                               device=dev))
    with pytest.raises(ValueError):
        ra.relpos_attention_cuda(q, k, v, g, r[:, 1:].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H", [(32, 200, 16), (1, 1, 1), (3, 2048, 2)])
def test_relpos_plan_matches_the_library(B, L, H):
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra

    _card()
    assert ra.relpos_plan_cuda(B, L, H) == ra.relpos_plan(B, L, H)


@pytest.mark.cuda
def test_relpos_layer_entry_routes_long_rows_to_the_twin_and_raises_for_the_rest():
    """``relpos_attention`` on the card: past ``MAX_L`` rows the plain twin,
    counted as ``msmd.k10.plain_calls`` and launching no K10; f32 or a head
    width other than 64 raises."""
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra
    from msmd_tpu_torch.utils.profiling import counters

    dev = _card()
    L = ra.MAX_L + 1
    q = torch.randn(1, L, 1, 64, device=dev).to(torch.bfloat16)
    g, r = torch.ones(1, 1, L, device=dev), torch.randn(1, 2 * L - 1, device=dev)
    before, launches = counters(), ra.relpos_attention_cuda.launches
    out = ra.relpos_attention(q, q, q, g, r)
    after = counters()
    assert out.shape == q.shape and bool(torch.isfinite(out.float()).all())
    assert after.get("msmd.k10.plain_calls", 0) - before.get("msmd.k10.plain_calls", 0) == 1
    assert ra.relpos_attention_cuda.launches == launches
    q, k, v, g, r, _ = _k10_case(dev, 1, 8)
    with pytest.raises(ValueError):
        ra.relpos_attention(q.float(), k.float(), v.float(), g, r)
    narrow = q[..., :32].contiguous()
    with pytest.raises(ValueError):
        ra.relpos_attention(narrow, narrow, narrow, g, r)


@pytest.mark.cuda
def test_wavlm_encoder_runs_k10_once_a_layer_each_way():
    """A bf16 WavLM encoder of head width 64 on the card: one K10 forward a
    layer a call, one backward a layer in training, one table a call
    (``msmd.k10.calls``, ``msmd.wavlm.bias_tables``); its output against
    the same encoder with the plain twin in K10's place."""
    from msmd_tpu_torch.config import AudioEncoderConfig
    from msmd_tpu_torch.models import audio as ma
    from msmd_tpu_torch.ops.kernels import relpos_attn as ra
    from msmd_tpu_torch.utils.profiling import counters

    dev = _card()
    c = AudioEncoderConfig(hidden_size=256, num_layers=3, num_heads=4, intermediate_size=512,
                           feat_extract_norm="layer", do_stable_layer_norm=True, num_buckets=320)
    torch.manual_seed(0)
    enc = ma.AudioEncoder(c, dtype=torch.bfloat16).to(dev)
    audio = torch.randn(2, 64000, device=dev)
    before = counters()
    out = enc(audio, 25, 200, rng=torch.Generator(device=dev).manual_seed(1))
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    after = counters()
    delta = lambda n: after.get(n, 0) - before.get(n, 0)
    assert delta("msmd.k10.calls") == 2 * c.num_layers and delta("msmd.wavlm.bias_tables") == 1
    assert delta("msmd.k10.fwd_rows") == delta("msmd.k10.bwd_rows") == 2 * 200 * c.num_layers
    assert enc.encoder.layers[0].rel_attn_embed.grad is not None
    with torch.no_grad():
        got = enc(audio, 25, 200)
        orig = ma.relpos_attention
        ma.relpos_attention = ra.relpos_attention_plain
        try:
            want = enc(audio, 25, 200)
        finally:
            ma.relpos_attention = orig
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    print(f"wavlm encoder K10 vs plain max|err|/max|plain| {err:.3g}")
    assert err <= 5e-2


@pytest.mark.cuda
def test_wavlm_large_msmd_serves_through_k10():
    """MSMD with ``audio_model="wavlm"`` at WavLM-Large's widths (bf16, seeded
    weights) through ``infer_coeffs`` (a 4 s clip, two takes) and
    ``StreamingBatcher`` (two streams of two windows over two slots): every
    encoder call runs K10 once a layer (24 forward calls, no backward) and
    builds one table; the motion is finite."""
    import numpy as np

    from msmd_tpu_torch.config import MSMDConfig
    from msmd_tpu_torch.inference_lib import infer_coeffs
    from msmd_tpu_torch.models.diffusion import get_diffusion_model
    from msmd_tpu_torch.serving import StreamingBatcher
    from msmd_tpu_torch.utils.profiling import counters

    dev = _card()
    cfg = MSMDConfig(audio_model="wavlm")
    model = get_diffusion_model(cfg, dtype=torch.bfloat16, device=dev, seed=3)
    assert model.audio_encoder.config.num_layers == 24 and model.audio_encoder.config.relative_position
    rng = np.random.default_rng(4)
    before = counters()
    with torch.no_grad():
        out = infer_coeffs(model, rng.standard_normal(64000).astype(np.float32), torch.zeros(1, 100),
                           style_feats=torch.zeros(1, cfg.d_style), n_repetitions=2, device=dev)
    torch.cuda.synchronize()
    mid = counters()
    bat = StreamingBatcher(model, max_slots=2, device=dev)
    for j in range(2):
        bat.add_stream(f"s{j}", seed=j, style=np.zeros(cfg.d_style, np.float32))
        bat.push_audio(f"s{j}", rng.standard_normal(2 * 64000).astype(np.float32), final=True)
    with torch.no_grad():
        bat.run_until_drained()
    after = counters()
    d1 = lambda n: mid.get(n, 0) - before.get(n, 0)
    d2 = lambda n: after.get(n, 0) - mid.get(n, 0)
    assert bool(torch.isfinite(torch.as_tensor(out)).all())
    assert all(np.isfinite(np.asarray(bat.output(f"s{j}"))).all() for j in range(2))
    for d in (d1, d2):
        tables = d("msmd.wavlm.bias_tables")
        assert tables >= 1 and d("msmd.k10.calls") == 24 * tables and d("msmd.k10.bwd_rows") == 0
