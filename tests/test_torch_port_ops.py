"""The port's ops (repmode_tpu_torch.ops, infer.tiling, metrics) against the
JAX package's functions on the same numpy inputs, on the CPU.

``conv3d_same`` on a CPU tensor runs its plain version, which defines the
CUDA kernel's arithmetic; it is held against the Pallas kernel it replaces
(``pallas_conv3d_same`` in interpret mode, as tests/test_pallas_kernels.py
runs it).
"""

import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repmode_tpu.infer.tiling import compute_patch_starts as jax_patch_starts
from repmode_tpu.metrics.aggregate import MetricAggregator as JaxAggregator
from repmode_tpu.metrics.metrics import metric_stats as jax_metric_stats
from repmode_tpu.ops import conv3d as jconv
from repmode_tpu.ops import mode as jmode
from repmode_tpu.ops.gaussian import gaussian_importance_map as jax_gaussian
from repmode_tpu.ops.norm import batch_norm_apply as jax_bn_apply
from repmode_tpu.ops.pallas.conv3d import pallas_conv3d_same
from repmode_tpu_torch.infer.tiling import compute_patch_starts
from repmode_tpu_torch.metrics.aggregate import MetricAggregator
from repmode_tpu_torch.metrics.metrics import metric_stats
from repmode_tpu_torch.ops import mode as tmode
from repmode_tpu_torch.ops.conv3d import (
    avg_pool_same,
    conv3d_same,
    downsample2x_conv,
    upsample2x_convt,
)
from repmode_tpu_torch.ops.gaussian import gaussian_importance_map
from repmode_tpu_torch.ops.norm import batch_norm_apply

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def npr(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- conv3d_same


@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
@pytest.mark.parametrize("co", [1, 4])
@pytest.mark.parametrize("ci", [1, 3])
@pytest.mark.parametrize("taps", [(5, 5, 5), (3, 5, 3), (1, 1, 1)])
def test_conv3d_same_matches_pallas_fp32(taps, ci, co, epilogue):
    """fp32 compute: the plain version equals the Pallas kernel within 1e-5."""
    rng = np.random.default_rng(zlib.crc32(repr((taps, ci, co, epilogue)).encode()))
    x = npr(rng, (1, 3, 6, 8, ci))
    w = npr(rng, taps + (ci, co))
    b = npr(rng, (co,)) if epilogue != "none" else None
    relu = epilogue == "bias_relu"
    ref = pallas_conv3d_same(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        relu=relu, compute_dtype=jnp.float32, interpret=True,
    )
    out = conv3d_same(t(x), t(w), None if b is None else t(b), relu=relu)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_conv3d_same_matches_pallas_bf16(out_dtype):
    """bf16 compute (inputs rounded, fp32 sums, fp32 epilogue) within 1e-3."""
    rng = np.random.default_rng(3)
    x = npr(rng, (2, 3, 6, 8, 3))
    w = npr(rng, (3, 5, 3, 3, 4))
    b = npr(rng, (4,))
    ref = pallas_conv3d_same(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu=True,
        compute_dtype=jnp.bfloat16, out_dtype=getattr(jnp, out_dtype), interpret=True,
    )
    out = conv3d_same(t(x), t(w), t(b), relu=True, compute_dtype=torch.bfloat16,
                      out_dtype=getattr(torch, out_dtype))
    assert out.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=1e-3, atol=1e-3
    )


def test_conv3d_same_cpu_does_not_launch():
    before = conv3d_same.launches
    conv3d_same(torch.zeros(1, 2, 2, 2, 1), torch.zeros(1, 1, 1, 1, 1))
    assert conv3d_same.launches == before


# ------------------------------------------------------ resample, pool, norm


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_downsample_upsample_match_jax(cdt):
    rng = np.random.default_rng(1)
    x = npr(rng, (2, 4, 6, 8, 3))
    wd = npr(rng, (2, 2, 2, 3, 5))
    wu = npr(rng, (2, 2, 2, 3, 5))
    jc = None if cdt is None else jnp.bfloat16
    tc = None if cdt is None else torch.bfloat16
    tol = 1e-5 if cdt is None else 1e-3
    np.testing.assert_allclose(
        downsample2x_conv(t(x), t(wd), compute_dtype=tc).numpy(),
        np.asarray(jconv.downsample2x_conv(jnp.asarray(x), jnp.asarray(wd), compute_dtype=jc)),
        rtol=tol, atol=tol,
    )
    np.testing.assert_allclose(
        upsample2x_convt(t(x), t(wu), compute_dtype=tc).numpy(),
        np.asarray(jconv.upsample2x_convt(jnp.asarray(x), jnp.asarray(wu), compute_dtype=jc)),
        rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("k", [3, 5])
def test_avg_pool_same_matches_jax(k):
    x = npr(np.random.default_rng(k), (2, 4, 5, 6, 3))
    np.testing.assert_allclose(
        avg_pool_same(t(x), k).numpy(), np.asarray(jconv.avg_pool_same(jnp.asarray(x), k)),
        rtol=1e-6, atol=1e-6,
    )


def test_batch_norm_apply_matches_jax():
    rng = np.random.default_rng(2)
    x = npr(rng, (2, 3, 4, 5, 6))
    mean, scale, bias = npr(rng, (6,)), npr(rng, (6,)), npr(rng, (6,))
    var = np.abs(npr(rng, (6,))) + 0.1
    ref = jax_bn_apply(*(jnp.asarray(a) for a in (x, mean, var, scale, bias)), 1e-5)
    out = batch_norm_apply(*(t(a) for a in (x, mean, var, scale, bias)), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- MoDE math


def _experts(rng, ci, co):
    return [npr(rng, s + (ci, co)) for s in ((5, 5, 5), (3, 3, 3), (1, 1, 1), (1, 1, 1), (1, 1, 1))]


def test_gate_bank_merge_match_jax():
    rng = np.random.default_rng(4)
    ci, co, e, n = 3, 4, 5, 2
    logits = npr(rng, (n, e * co), 2.0)
    g_ref = jmode.gate_logits_to_weights(jnp.asarray(logits), e, co)
    g = tmode.gate_logits_to_weights(t(logits), e, co)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-6, atol=1e-7)

    ws = _experts(rng, ci, co)
    jek = jmode.ExpertKernels(*(jnp.asarray(w) for w in ws))
    tek = tmode.ExpertKernels(*(t(w) for w in ws))
    np.testing.assert_allclose(
        tmode.expert_bank(tek).numpy(), np.asarray(jmode.expert_bank(jek)), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        tmode.merge_kernels(tek, g).numpy(),
        np.asarray(jmode.merge_kernels(jek, g_ref)), rtol=1e-5, atol=1e-6,
    )


def test_mode_conv_expert_sum_matches_jax():
    rng = np.random.default_rng(5)
    ci, co = 3, 4
    x = npr(rng, (2, 4, 6, 6, ci))
    ws = _experts(rng, ci, co)
    g = np.asarray(jax.nn.softmax(npr(rng, (2, 5, co), 2.0), axis=1))
    ref = jmode.mode_conv_expert_sum(
        jnp.asarray(x), jmode.ExpertKernels(*(jnp.asarray(w) for w in ws)), jnp.asarray(g))
    out = tmode.mode_conv_expert_sum(t(x), tmode.ExpertKernels(*(t(w) for w in ws)), t(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------- gaussian, tiling, metrics


@pytest.mark.parametrize("patch", [(16, 16, 16), (32, 128, 128), (8, 20, 12)])
def test_gaussian_importance_map_equals_jax(patch):
    np.testing.assert_array_equal(gaussian_importance_map(patch), jax_gaussian(patch))


@pytest.mark.parametrize(
    "vol,patch",
    [((16, 24, 24), (16, 16, 16)), ((32, 624, 924), (32, 128, 128)), ((40, 130, 129), (32, 64, 64))],
)
def test_compute_patch_starts_equals_jax(vol, patch):
    np.testing.assert_array_equal(compute_patch_starts(vol, patch), jax_patch_starts(vol, patch))


def test_metrics_and_csvs_match_jax(tmp_path):
    rng = np.random.default_rng(6)
    ours, ref = MetricAggregator(), JaxAggregator()
    for i, ds in enumerate(["b_task", "a_task", "b_task", "a_task", "c_task"]):
        p, tg = npr(rng, (4, 5, 6)), npr(rng, (4, 5, 6))
        stats, ref_stats = metric_stats(p, tg), jax_metric_stats(p, tg)
        assert stats == ref_stats
        ours.add(ds, f"vol{i}.czi", stats)
        ref.add(ds, f"vol{i}.czi", ref_stats)
    log, ref_log = ours.log_dict("test"), ref.log_dict("test")
    assert log.keys() == ref_log.keys()
    for k in log:
        assert log[k] == pytest.approx(ref_log[k], rel=1e-12)
    ours.to_csvs(str(tmp_path / "ours"), "e")
    ref.to_csvs(str(tmp_path / "ref"), "e")
    for prefix in ("comp", "spec", "final"):
        a = (tmp_path / "ours" / f"{prefix}_e.csv").read_text().splitlines()
        b = (tmp_path / "ref" / f"{prefix}_e.csv").read_text().splitlines()
        assert a[0] == b[0] and len(a) == len(b)
        for ra, rb in zip(a[1:], b[1:]):
            fa, fb = ra.split(","), rb.split(",")
            for va, vb in zip(fa, fb):
                try:
                    assert float(va) == pytest.approx(float(vb), rel=1e-12)
                except ValueError:
                    assert va == vb


# ------------------------------------------------------------------ hygiene


def test_port_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports every port module and gains no jax module,
    nothing of repmode_tpu and no pandas (the card's machine has none)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "before = set(sys.modules)\n"
        "import repmode_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repmode_tpu',\n"
        "                                                  'pandas'))\n"
        "assert len(names) >= 20, names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax_import():
    """No source file of the port imports jax, flax, repmode_tpu or pandas, even
    lazily; ``native/`` is scanned with the rest, and its C++ source is there."""
    import ast

    root = os.path.join(REPO, "repmode_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            for node in ast.walk(ast.parse(open(path).read(), path)):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                bad += [(path, m) for m in mods
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "repmode_tpu", "pandas")]
    assert not bad, bad
    assert os.path.isfile(os.path.join(root, "native", "__init__.py"))
    assert os.path.isfile(os.path.join(root, "native", "patchops.cpp"))


@pytest.mark.parametrize("ci,taps", [(1, (5, 5, 5)), (3, (3, 5, 3)), (5, (1, 1, 1)), (9, (3, 3, 3))])
def test_narrow_input_packing_keeps_the_conv(ci, taps):
    """The CUDA wrapper's channel packing (kW taps of a narrow input moved
    into channels, then zero channels up to a multiple of 8) leaves the
    conv's value unchanged."""
    from repmode_tpu_torch.ops.conv3d import _to_multiple_of_8_channels, conv3d_same_plain

    rng = np.random.default_rng(ci)
    x, w = t(npr(rng, (2, 3, 5, 7, ci))), t(npr(rng, taps + (ci, 4)))
    xp, wp = _to_multiple_of_8_channels(x, w)
    assert xp.shape[-1] % 8 == 0 and wp.shape[3] == xp.shape[-1]
    np.testing.assert_allclose(conv3d_same_plain(xp, wp).numpy(),
                               conv3d_same_plain(x, w).numpy(), rtol=1e-5, atol=1e-5)
