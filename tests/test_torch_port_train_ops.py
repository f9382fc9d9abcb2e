"""The training path's ops against the JAX package, on the CPU.

  * K2, K3 and K4: the plain versions of ``conv3d_same_persample`` (forward
    and ``transpose_taps``) and ``conv3d_dw_persample``, which define the CUDA
    kernels' arithmetic, against the Pallas functions they replace in
    interpret mode, at native 5^3 taps;
  * ``MergedConvPerSample`` against JAX ``merged_conv_persample`` (value and
    both VJPs), and the merged MoDE conv against the expert sum;
  * ``GateMergePerSample`` against the bank einsum (fp64 gradients, bf16
    bits), JAX's ``merge_kernels`` and its VJP, and the sums its CUDA
    kernels compute;
    their tiles, and the CUDA route's refusals;
  * ``batch_norm_train`` against JAX's;
  * the CUDA wrappers' operand packing (narrow channels) and the shared-kernel
    conv's refusal to run under autograd on the card.
"""

import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repmode_tpu.ops import mode as jmode
from repmode_tpu.ops.norm import batch_norm_train as jax_bn_train
from repmode_tpu.ops.pallas.conv3d import (
    pallas_conv3d_dw_persample,
    pallas_conv3d_same_persample,
)
from repmode_tpu_torch.ops import conv3d as tconv
from repmode_tpu_torch.ops import mode as tmode
from repmode_tpu_torch.ops.conv3d import conv3d_dw_persample, conv3d_same_persample
from repmode_tpu_torch.ops.norm import batch_norm_train

torch.set_num_threads(2)

SHAPE = (2, 8, 8, 8)  # N, D, H, W


def npr(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def operands(ci, co, seed):
    rng = np.random.default_rng(seed)
    return npr(rng, SHAPE + (ci,)), npr(rng, (SHAPE[0], 5, 5, 5, ci, co)), npr(rng, SHAPE + (co,))


def pallas(kernel, x, w, dy, dtype):
    """The Pallas function a port kernel replaces, in interpret mode."""
    if kernel == "dw":
        return pallas_conv3d_dw_persample(jnp.asarray(x), jnp.asarray(dy), 5, 5, 5,
                                          compute_dtype=dtype, interpret=True)
    inp = dy if kernel == "transpose" else x
    return pallas_conv3d_same_persample(
        jnp.asarray(inp), jnp.asarray(w), compute_dtype=dtype, out_dtype=jnp.float32,
        transpose_taps=kernel == "transpose", interpret=True)


def port(kernel, x, w, dy, dtype):
    if kernel == "dw":
        return conv3d_dw_persample(t(x), t(dy), 5, 5, 5, compute_dtype=dtype)
    inp = dy if kernel == "transpose" else x
    return conv3d_same_persample(t(inp), t(w), transpose_taps=kernel == "transpose",
                                 compute_dtype=dtype, out_dtype=torch.float32)


# each of 1, 4 and 8 channels appears on the input and on the output side of
# each kernel
@pytest.mark.parametrize("kernel,ci,co", [
    *((k, ci, co) for k in ("forward", "transpose") for ci, co in ((1, 8), (4, 1), (8, 4))),
    ("dw", 1, 8), ("dw", 8, 1), ("dw", 4, 4),
])
def test_persample_plain_matches_pallas_fp32(kernel, ci, co):
    """fp32 compute: the plain version equals the Pallas function, rtol 1e-5."""
    x, w, dy = operands(ci, co, zlib.crc32(repr((kernel, ci, co)).encode()))
    ref = np.asarray(pallas(kernel, x, w, dy, jnp.float32))
    out = port(kernel, x, w, dy, None)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["forward", "transpose", "dw"])
def test_persample_plain_matches_pallas_bf16(kernel):
    """bf16 compute (inputs rounded, fp32 sums): within 1e-4 relative to the
    output's largest magnitude; the two differ only in summation order."""
    x, w, dy = operands(4, 8, 11)
    ref = np.asarray(pallas(kernel, x, w, dy, jnp.bfloat16))
    out = port(kernel, x, w, dy, torch.bfloat16).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_merged_conv_persample_matches_jax_vjp():
    """MergedConvPerSample's value and both VJPs against JAX's custom_vjp
    (merged_conv_persample with the Pallas kernels in interpret mode), fp32."""
    x, w, dy = operands(4, 8, 3)
    y_ref, vjp = jax.vjp(lambda a, b: jmode.merged_conv_persample(a, b, True),
                         jnp.asarray(x), jnp.asarray(w))
    dx_ref, dw_ref = vjp(jnp.asarray(dy))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    y = tmode.MergedConvPerSample.apply(xt, wt)
    y.backward(t(dy))
    for ours, ref in ((y, y_ref), (xt.grad, dx_ref), (wt.grad, dw_ref)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _experts(rng, ci, co):
    return [npr(rng, s + (ci, co)) for s in ((5, 5, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1))]


def test_merged_route_matches_expert_sum_with_grads():
    """The merged route and the expert sum compute one function: values and
    gradients of x, the five experts and the gate logits agree (fp64)."""
    rng = np.random.default_rng(5)
    ci, co, e = 3, 4, 5
    x = t(npr(rng, (2, 4, 6, 6, ci))).double()
    ws = [t(w).double() for w in _experts(rng, ci, co)]
    logits = t(npr(rng, (2, e * co), 2.0)).double()
    dy = t(npr(rng, (2, 4, 6, 6, co))).double()

    def run(op):
        xx = x.clone().requires_grad_()
        ek = tmode.ExpertKernels(*(w.clone().requires_grad_() for w in ws))
        lg = logits.clone().requires_grad_()
        y = op(xx, ek, tmode.gate_logits_to_weights(lg, e, co))
        y.backward(dy)
        return [y.detach(), xx.grad, *(w.grad for w in ek), lg.grad]

    merged = run(tmode.mode_conv_merged_persample)
    ref = run(tmode.mode_conv_expert_sum)
    for a, b in zip(merged, ref):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-10)


def _merge_as_kernels_compute(ws, g):
    """The gate merge as ``csrc/gate_merge.cu`` writes it: each expert added
    on its own support, the pools' 1^3 kernels scaled by 1/27 and 1/125."""
    w5, w3, w1, wa3, wa5 = ws
    ge = [g[:, e, None, None, None, None, :] for e in range(5)]
    wn = ge[0] * w5 + ge[4] * wa5 / 125
    wn[:, 1:4, 1:4, 1:4] += ge[1] * w3 + ge[3] * wa3 / 27
    wn[:, 2:3, 2:3, 2:3] += ge[2] * w1
    return wn


def _merge_grads_as_kernels_compute(ws, g, dw):
    """The gate merge's backward as ``csrc/gate_merge.cu`` writes it: the
    five weight gradients from sums over the samples, the gate's from sums
    over taps and input channels."""
    w5, w3, w1, wa3, wa5 = ws
    c3, c1 = dw[:, 1:4, 1:4, 1:4], dw[:, 2:3, 2:3, 2:3]
    s3 = c3.sum((1, 2, 3), keepdim=True)
    s5 = dw.sum((1, 2, 3), keepdim=True)

    def over_n(e, d):
        return (g[:, e, None, None, None, None, :] * d).sum(0)

    def over_ti(a, b):
        return (a * b).sum((1, 2, 3, 4))

    grads = [over_n(0, dw), over_n(1, c3), over_n(2, c1), over_n(3, s3) / 27, over_n(4, s5) / 125]
    dg = torch.stack([over_ti(dw, w5), over_ti(c3, w3), over_ti(c1, w1), over_ti(s3, wa3 / 27),
                      over_ti(s5, wa5 / 125)], dim=1)
    return grads + [dg]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("ci,co", [(1, 4), (3, 4), (4, 1), (8, 8)])
def test_gate_merge_persample_is_the_bank_einsum(n, ci, co):
    """``GateMergePerSample`` on the CPU against autograd through the expert
    bank and the einsum, the experts as views of (Co,Ci,k,k,k) parameters as
    the net holds them: fp64 forward and gradients to 1e-12, the bf16 merged
    kernels bit for bit; the forward against JAX's ``merge_kernels``; and
    the sums the CUDA kernels compute (``csrc/gate_merge.cu``), in fp64,
    against both."""
    rng = np.random.default_rng(100 * n + 10 * ci + co)
    ws = _experts(rng, ci, co)
    g = np.asarray(jax.nn.softmax(npr(rng, (n, 5, co), 2.0), axis=1))
    dw = npr(rng, (n, 5, 5, 5, ci, co))

    def leaves(dtype):
        params = [t(w).to(dtype).permute(4, 3, 0, 1, 2).contiguous().requires_grad_() for w in ws]
        return params, tmode.ExpertKernels(*(p.permute(2, 3, 4, 1, 0) for p in params))

    params, ek = leaves(torch.float64)
    gt = t(g).double().requires_grad_()
    wn = tmode.gate_merge_persample(ek, gt, torch.float64)
    wn.backward(t(dw).double())
    rparams, rek = leaves(torch.float64)
    rg = t(g).double().requires_grad_()
    ref = torch.einsum("neo,edhwio->ndhwio", rg, tmode.expert_bank(rek))
    ref.backward(t(dw).double())
    ours = [p.grad for p in params] + [gt.grad]
    theirs = [p.grad for p in rparams] + [rg.grad]
    torch.testing.assert_close(wn, ref, rtol=1e-12, atol=1e-12)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
        assert a.is_contiguous()

    ek64 = [t(w).double() for w in ws]
    torch.testing.assert_close(_merge_as_kernels_compute(ek64, t(g).double()), ref.detach(),
                               rtol=1e-12, atol=1e-12)
    model = _merge_grads_as_kernels_compute(ek64, t(g).double(), t(dw).double())
    for a, b in zip(model, [ek_grad.permute(2, 3, 4, 1, 0) for ek_grad in theirs[:5]] + theirs[5:]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)

    _, ek32 = leaves(torch.float32)
    with torch.no_grad():
        bf = tmode.gate_merge_persample(ek32, t(g), torch.bfloat16)
        want = torch.einsum("neo,edhwio->ndhwio", t(g), tmode.expert_bank(ek32)).to(torch.bfloat16)
        assert bf.dtype == torch.bfloat16 and torch.equal(bf, want)
        jax_wn = jmode.merge_kernels(jmode.ExpertKernels(*map(jnp.asarray, ws)), jnp.asarray(g))
        np.testing.assert_allclose(tmode.gate_merge_persample(ek32, t(g), torch.float32).numpy(),
                                   np.asarray(jax_wn), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,ci,co", [(1, 1, 4), (3, 8, 8)])
def test_gate_merge_persample_matches_jax_vjp(n, ci, co):
    """``GateMergePerSample``'s value and its six gradients (the five experts,
    as views of (Co,Ci,k,k,k) parameters, and the gate) against
    ``jax.vjp`` of JAX's ``merge_kernels`` on the same operands, fp64, to
    1e-12."""
    rng = np.random.default_rng(1000 * n + 10 * ci + co)
    ws = [w.astype(np.float64) for w in _experts(rng, ci, co)]
    g = npr(rng, (n, 5, co), 2.0).astype(np.float64)
    dw = npr(rng, (n, 5, 5, 5, ci, co)).astype(np.float64)
    with jax.enable_x64(True):
        wn_ref, vjp = jax.vjp(lambda ek, gg: jmode.merge_kernels(jmode.ExpertKernels(*ek), gg),
                              tuple(map(jnp.asarray, ws)), jnp.asarray(g))
        dek_ref, dg_ref = vjp(jnp.asarray(dw))
        refs = [np.asarray(wn_ref)] + [np.asarray(d) for d in dek_ref] + [np.asarray(dg_ref)]
    params = [t(w).permute(4, 3, 0, 1, 2).contiguous().requires_grad_() for w in ws]
    gt = t(g).requires_grad_()
    wn = tmode.gate_merge_persample(
        tmode.ExpertKernels(*(p.permute(2, 3, 4, 1, 0) for p in params)), gt, torch.float64)
    wn.backward(t(dw))
    ours = [wn.detach()] + [p.grad.permute(2, 3, 4, 1, 0) for p in params] + [gt.grad]
    for k, (a, b) in enumerate(zip(ours, refs)):
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape, k
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-12, err_msg=str(k))


def test_gate_merge_plan_tiles_every_training_conv():
    """The CUDA kernels' tiles at every MoDE conv of a batch-8 step at
    mult_chan 32 and 4: at most 64 (i, o) pairs a tile, 64 output channels
    where Co is above it, the input tiles covered once by the groups, the
    samples once by the forward's blocks."""
    for c in (32, 4):
        chans = [c, 2 * c, 4 * c, 8 * c, 16 * c]
        convs = [(1, c), (c, c)] + [(chans[k], chans[k + 1]) for k in range(4)] + \
                [(chans[k + 1], chans[k + 1]) for k in range(4)] + \
                [(2 * chans[k], chans[k]) for k in range(4)] + [(chans[k], chans[k]) for k in range(4)] + \
                [(c, 1)]
        assert len(convs) == 19
        for ci, co in convs:
            p = tmode.gate_merge_plan(8, ci, co)
            assert p["bo"] * p["bi"] <= 64 and p["bo"] == min(co, 64)
            assert p["otiles"] * p["bo"] >= co and p["itiles"] * p["bi"] >= ci
            assert (p["groups"] - 1) * p["tiles_per_group"] < p["itiles"] <= \
                p["groups"] * p["tiles_per_group"]
            assert p["otiles"] * p["groups"] < 2 * 264 + p["otiles"]
            assert 1 <= p["samples_per_block"] <= 8


@pytest.mark.parametrize("bad", ["fp32_compute", "kernel_size_3", "fp64_experts"])
def test_gate_merge_cuda_refuses_what_it_does_not_take(bad):
    """The CUDA route checks its operands before anything reaches the card:
    bf16 compute, kernel size 5 and fp32 experts, else a ValueError that
    names what it takes."""
    rng = np.random.default_rng(8)
    ws = [t(w) for w in _experts(rng, 4, 8)]
    g = torch.full((2, 5, 8), 0.2)
    cdt, ks = torch.bfloat16, 5
    if bad == "fp32_compute":
        cdt = torch.float32
    elif bad == "kernel_size_3":
        ks = 3
    else:
        ws = [w.double() for w in ws]
    with pytest.raises(ValueError, match="gate_merge_persample: the CUDA kernel"):
        tmode._gate_merge_cuda(tmode.ExpertKernels(*ws), g, cdt, ks)


def test_mode_conv_single_is_the_merged_conv_of_a_uniform_batch():
    rng = np.random.default_rng(6)
    ci, co, e = 3, 4, 5
    x = t(npr(rng, (2, 4, 6, 6, ci)))
    ek = tmode.ExpertKernels(*(t(w) for w in _experts(rng, ci, co)))
    g = tmode.gate_logits_to_weights(t(npr(rng, (1, e * co), 2.0)), e, co)
    w = tmode.merge_kernels(ek, g)[0]
    torch.testing.assert_close(tmode.mode_conv_single(x, w),
                               tmode.mode_conv_merged_persample(x, ek, g.expand(2, e, co)),
                               rtol=1e-5, atol=1e-5)


def test_merged_conv_skips_dx_when_input_needs_no_grad(monkeypatch):
    calls = []

    def recording(x, w, *, transpose_taps=False, **kw):
        calls.append(transpose_taps)
        return conv3d_same_persample(x, w, transpose_taps=transpose_taps, **kw)

    monkeypatch.setattr(tmode, "conv3d_same_persample", recording)
    x, w, _ = operands(4, 8, 4)
    wt = t(w).requires_grad_()
    tmode.MergedConvPerSample.apply(t(x), wt).sum().backward()
    assert calls == [False] and wt.grad is not None  # forward only, no dx
    calls.clear()
    xt = t(x).requires_grad_()
    tmode.MergedConvPerSample.apply(xt, t(w)).sum().backward()
    assert calls == [False, True] and xt.grad is not None


def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(2)
    x = npr(rng, (2, 3, 4, 5, 6), 2.0) + 0.7
    scale, bias = npr(rng, (6,)), npr(rng, (6,))
    rm, rv = npr(rng, (6,)), np.abs(npr(rng, (6,))) + 0.5
    y_ref, m_ref, v_ref = jax_bn_train(*(jnp.asarray(a) for a in (x, rm, rv, scale, bias)),
                                       momentum=0.1, eps=1e-5)
    rm_t, rv_t, nbt = t(rm), t(rv), torch.tensor(0)
    y = batch_norm_train(t(x), rm_t, rv_t, t(scale), t(bias), momentum=0.1, eps=1e-5,
                         num_batches_tracked=nbt)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rm_t.numpy(), np.asarray(m_ref), rtol=1e-6)
    np.testing.assert_allclose(rv_t.numpy(), np.asarray(v_ref), rtol=1e-6)
    assert int(nbt) == 1


# ------------------------------------------------- the CUDA wrappers' glue


@pytest.mark.parametrize("ci,co", [(1, 4), (4, 1), (1, 1), (3, 5), (16, 8)])
@pytest.mark.parametrize("taps", [(5, 5, 5), (3, 5, 3), (1, 1, 1)])
def test_persample_operand_packing_keeps_the_function(ci, co, taps):
    """The CUDA wrappers pack or pad narrow channel counts to multiples of 8
    before the kernels run; on those operands the plain versions give the
    same values (the transposed conv and dW unpacked) as on the originals."""
    g = torch.Generator().manual_seed(ci * 100 + co)
    x = torch.randn((2, 3, 4, 6, ci), generator=g, dtype=torch.float64)
    w = torch.randn((2, *taps, ci, co), generator=g, dtype=torch.float64)
    dy = torch.randn((2, 3, 4, 6, co), generator=g, dtype=torch.float64)
    plain, dw_plain = tconv.conv3d_same_persample_plain, tconv.conv3d_dw_persample_plain

    xb, wb = tconv._persample_operands(x, w, False)
    assert xb.shape[-1] % 8 == 0 and wb.shape[-1] % 8 == 0 and wb.shape[4] == xb.shape[-1]
    torch.testing.assert_close(plain(xb, wb)[..., :co], plain(x, w))
    db, wb = tconv._persample_operands(dy, w, True)
    assert db.shape[-1] % 8 == 0
    torch.testing.assert_close(plain(db, wb, transpose_taps=True),
                               plain(dy, w, transpose_taps=True))
    xb, dyb, kw = tconv._dw_operands(x, dy, taps[2])
    assert xb.shape[-1] % 8 == 0 and dyb.shape[-1] % 8 == 0
    torch.testing.assert_close(
        tconv._dw_unpack(dw_plain(xb, dyb, taps[0], taps[1], kw), ci, co, taps[2]),
        dw_plain(x, dy, *taps))


def test_persample_plains_are_adjoint():
    """<conv(x, w), dy> = <x, convT(dy, w)> = <w, dW(x, dy)>: the transposed
    conv and dW are the two VJPs of the forward."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 3, 5, 7, 3), generator=g, dtype=torch.float64)
    w = torch.randn((2, 5, 3, 5, 3, 6), generator=g, dtype=torch.float64)
    dy = torch.randn((2, 3, 5, 7, 6), generator=g, dtype=torch.float64)
    lhs = (tconv.conv3d_same_persample_plain(x, w) * dy).sum()
    torch.testing.assert_close(
        lhs, (x * tconv.conv3d_same_persample_plain(dy, w, transpose_taps=True)).sum())
    torch.testing.assert_close(lhs, (w * tconv.conv3d_dw_persample_plain(x, dy, 5, 3, 5)).sum())


def test_persample_wrappers_on_cpu_do_not_launch():
    x, w, dy = operands(4, 8, 9)
    before = (conv3d_same_persample.launches, conv3d_same_persample.transpose_launches,
              conv3d_dw_persample.launches)
    port("forward", x, w, dy, None)
    port("transpose", x, w, dy, None)
    port("dw", x, w, dy, None)
    assert before == (conv3d_same_persample.launches, conv3d_same_persample.transpose_launches,
                      conv3d_dw_persample.launches)


def test_conv3d_same_refuses_autograd_on_cuda(monkeypatch):
    """K1 has no backward: on a CUDA tensor with grad enabled and an input
    that requires grad the wrapper raises before launching; under no_grad it
    launches. A stub stands in for the CUDA tensor and the kernel."""
    launched = []
    monkeypatch.setattr(tconv, "_conv3d_same_cuda", lambda *a: launched.append(a) or "y")
    x = types.SimpleNamespace(device=torch.device("cuda"), requires_grad=False)
    w = types.SimpleNamespace(device=torch.device("cuda"), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tconv.conv3d_same(x, w)
    assert not launched
    before = tconv.conv3d_same.launches
    with torch.no_grad():
        assert tconv.conv3d_same(x, w) == "y"
    w.requires_grad = False
    assert tconv.conv3d_same(x, w) == "y"
    assert len(launched) == 2 and tconv.conv3d_same.launches == before + 2
