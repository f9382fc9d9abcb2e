"""The training path's ops against the JAX package, on the CPU.

  * K2, K3 and K4: the plain versions of ``conv3d_same_persample`` (forward
    and ``transpose_taps``) and ``conv3d_dw_persample``, which define the CUDA
    kernels' arithmetic, against the Pallas functions they replace in
    interpret mode, at native 5^3 taps;
  * ``MergedConvPerSample`` against JAX ``merged_conv_persample`` (value and
    both VJPs), and the merged MoDE conv against the expert sum;
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
