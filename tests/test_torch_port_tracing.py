"""The port's spans (``utils/timing.span``) on the CPU, at test size.

One piece of work, run twice from the same seeds (a host-sampler epoch of
two native train steps, a ``prepare`` and one tiled volume): once
with no profiler, where no ``rm.`` range may be entered, and once under
``torch.profiler``, where each span occurs as often as the paths say and
nests where it should. Both runs give bit-equal losses, parameters and
predictions. The same for the plain U-Nets (``UNet``, ``fnet_nn_3d``): a
train step and a tiled volume, with the ``rm.unet.`` spans of their convs
and BNs, and the ``conv3d_same_autograd.calls`` counter. Then
``bench_torch.spans.span_split`` on events built by hand, its per-unit
readings, and ``bench_torch.profile``'s kernel filter, which counts no
span's annotation on the device's timeline.
"""

from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from bench_torch import profile as bench_profile
from bench_torch import spans as bench_spans
from repmode_tpu_torch.config import Config, DataConfig, EvalConfig, ModelConfig, TrainConfig
from repmode_tpu_torch.data.sampler import PatchSampler
from repmode_tpu_torch.data.synthetic import synthetic_store
from repmode_tpu_torch.infer.predict import TiledPredictor
from repmode_tpu_torch.models.repmode import MoDEConv
from repmode_tpu_torch.models.reparam import make_inference
from repmode_tpu_torch.ops import conv3d as conv3d_mod
from repmode_tpu_torch.train.loop import run_train_epoch
from repmode_tpu_torch.train.state import create_train_state
from repmode_tpu_torch.train.step import make_train_step
from repmode_tpu_torch.utils import timing

torch.set_num_threads(2)

PATCH, VOLUME = (8, 16, 16), (8, 24, 40)   # 2 x 4 patches: 4 batches of 2


def _cfg() -> Config:
    return Config(model=ModelConfig(mult_chan=2, depth=2, train_s2d=False),
                  data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
                  train=TrainConfig(batch_size=2, batch_size_eval=2, patch_size=PATCH,
                                    compute_dtype="float32"),
                  eval=EvalConfig(patch_size=PATCH, s2d=False))


def _work(cfg: Config) -> dict:
    """One sampler epoch of two train steps, then a prepare and a volume."""
    store = synthetic_store(cfg.data.adopted_datasets, 2, vol_shape=VOLUME)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    sampler = PatchSampler(store, 2, PATCH, seed=0, use_native=False)
    log = run_train_epoch(cfg, state, make_train_step(cfg, state), sampler, 0)
    prepare, _ = make_inference(cfg)
    predictor = TiledPredictor(cfg, device="cpu")
    pred = predictor(prepare(state.net.state_dict(), 1), store[0].signal)
    return {"loss": log["loss/epoch"], "pred": pred,
            "params": [p.detach().clone() for p in state.net.parameters()],
            "mode_convs": sum(isinstance(m, MoDEConv) for m in state.net.modules()),
            "batches": len(predictor.grid(VOLUME)[0])}


@pytest.fixture(scope="module")
def runs():
    cfg = _cfg()
    entered = []
    real = torch.autograd.profiler.record_function.__init__

    def init(self, name, args=None):
        entered.append(name)
        real(self, name, args)

    with mock.patch.object(torch.autograd.profiler.record_function, "__init__", init):
        off = _work(cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = _work(cfg)
    # the recorded ranges as (name, start, end); prof.events() would take ~10 s
    # to build its tree of 160k ops
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return {"off": off, "entered": entered, "on": on, "ranges": ranges}


def test_no_span_without_a_profiler(runs):
    assert not [n for n in runs["entered"] if n.startswith(timing.PREFIX)]


def _around(r, ranges):
    """The names of the ranges that hold range r in time."""
    return [n for n, a, b in ranges if a <= r[1] and r[2] <= b and (n, a, b) != r]


def test_spans_under_the_profiler(runs):
    on = runs["on"]
    mine = [r for r in runs["ranges"] if r[0].startswith("rm.")]
    count = {n: sum(r[0] == n for r in mine) for n in {r[0] for r in mine}}
    m, nb = on["mode_convs"], on["batches"]
    assert m > 0 and nb == 4
    assert count == {"rm.sampler.wait": 2, "rm.loop.h2d": 2, "rm.step": 2,
                     "rm.mode.merge": 2 * m, "rm.mode.merge_bwd": 2 * m,
                     "rm.mode.conv": 2 * 2 * m,
                     "rm.reparam.prepare": 1, "rm.predict": 1, "rm.predict.h2d": 1,
                     "rm.predict.stitch": 2 * nb + 1}
    for r in mine:
        up = _around(r, mine)
        if r[0].startswith("rm.mode."):
            assert up == ["rm.step"], r
        if r[0].startswith("rm.predict."):
            assert up == ["rm.predict"], r
        if r[0] in ("rm.sampler.wait", "rm.loop.h2d", "rm.reparam.prepare", "rm.predict"):
            assert up == [], r
    # half of the conv spans are the hand-written backward's
    engine = [r for r in runs["ranges"]
              if r[0].startswith("autograd::engine::evaluate_function")]
    backward = [r for r in mine if r[0] == "rm.mode.conv" and _around(r, engine)]
    assert len(backward) == 2 * m
    # every gate-merge backward runs in autograd's engine, outside the conv's
    merge_bwd = [r for r in mine if r[0] == "rm.mode.merge_bwd" and _around(r, engine)]
    assert len(merge_bwd) == 2 * m


def test_profiler_leaves_the_numbers_alone(runs):
    off, on = runs["off"], runs["on"]
    assert off["loss"] == on["loss"]
    assert all(torch.equal(a, b) for a, b in zip(off["params"], on["params"]))
    assert torch.equal(off["pred"], on["pred"])


def test_span_is_a_shared_null_context_when_off():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert timing.span("step") is timing.span("predict", 3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        s = timing.span("step", 7)
        assert isinstance(s, torch.profiler.record_function)
        with s:
            pass
    assert [e.name for e in prof.events() if e.name.startswith("rm.")] == ["rm.step"]


def _unet_cfg(model: str) -> Config:
    return Config(model=ModelConfig(name=model, mult_chan=2, depth=2,
                                    kernel_size=3 if model == "fnet_nn_3d" else 5),
                  data=DataConfig(adopted_datasets=("dna", "lamin_b1")),
                  train=TrainConfig(batch_size=2, batch_size_eval=2, patch_size=PATCH,
                                    compute_dtype="float32"),
                  eval=EvalConfig(patch_size=PATCH, s2d=False))


def _unet_work(cfg: Config) -> dict:
    """One train step on a fixed batch, then a prepare and a volume."""
    store = synthetic_store(cfg.data.adopted_datasets, 1, vol_shape=VOLUME)
    state = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"signal": torch.randn((2, *PATCH, 1), generator=g),
             "target": torch.randn((2, *PATCH, 1), generator=g), "task": torch.tensor([0, 1])}
    calls = conv3d_mod.conv3d_same_autograd.calls
    loss = make_train_step(cfg, state)(batch)["loss"]
    step_calls = conv3d_mod.conv3d_same_autograd.calls - calls
    prepare, _ = make_inference(cfg)
    predictor = TiledPredictor(cfg, device="cpu")
    calls = conv3d_mod.conv3d_same_autograd.calls
    pred = predictor(prepare(state.net.state_dict(), 1), store[0].signal)
    return {"loss": loss, "pred": pred, "step_calls": step_calls,
            "volume_calls": conv3d_mod.conv3d_same_autograd.calls - calls,
            "params": [p.detach().clone() for p in state.net.parameters()],
            "batches": len(predictor.grid(VOLUME)[0])}


@pytest.fixture(scope="module", params=["UNet", "fnet_nn_3d"])
def unet_runs(request):
    cfg = _unet_cfg(request.param)
    entered = []
    real = torch.autograd.profiler.record_function.__init__

    def init(self, name, args=None):
        entered.append(name)
        real(self, name, args)

    with mock.patch.object(torch.autograd.profiler.record_function, "__init__", init):
        off = _unet_work(cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = _unet_work(cfg)
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return {"off": off, "entered": entered, "on": on, "ranges": ranges}


def test_unet_spans_and_autograd_conv_calls(unet_runs):
    """Depth 2: 4 * 2 + 3 = 11 'same' convs a forward (8 + 2 in the
    subnets, conv_out) and 6 * 2 + 2 = 14 BN + ReLU (10 after a subnet's
    convs, 2 after the downsamples, 2 after the upsamples). A train step runs
    the forward once (its backward opens no span) and calls the autograd
    conv 11 times; a served volume runs the eval forward once a batch, every
    conv through ``conv3d_same`` (K1 on the card), the autograd conv never."""
    off, on = unet_runs["off"], unet_runs["on"]
    assert not [n for n in unet_runs["entered"] if n.startswith(timing.PREFIX)]
    assert off["loss"] == on["loss"] and torch.equal(off["pred"], on["pred"])
    assert all(torch.equal(a, b) for a, b in zip(off["params"], on["params"]))
    for run in (off, on):
        assert (run["step_calls"], run["volume_calls"]) == (11, 0)
    nb = on["batches"]
    assert nb == 4
    mine = [r for r in unet_runs["ranges"] if r[0].startswith("rm.")]
    count = {n: sum(r[0] == n for r in mine) for n in {r[0] for r in mine}}
    assert count == {"rm.step": 1, "rm.unet.conv": 11 * (1 + nb), "rm.unet.bn": 14 * (1 + nb),
                     "rm.reparam.prepare": 1, "rm.predict": 1, "rm.predict.h2d": 1,
                     "rm.predict.stitch": 2 * nb + 1}
    for r in mine:
        if r[0].startswith("rm.unet."):
            assert _around(r, mine) in (["rm.step"], ["rm.predict"]), r


# (name, start, end) in microseconds; window [0, 110)
HOST = [("rm.step", 2, 100), ("rm.mode.merge", 10, 20), ("aten::copy_", 15, 18),
        ("rm.mode.conv", 20, 40), ("rm.mode.conv", 60, 80), ("rm.sampler.wait", 100, 110),
        ("rm.loop.h2d", 120, 130)]
ANNOTATIONS = [("rm.step", 5, 95), ("rm.mode.merge", 12, 19), ("rm.mode.conv", 22, 45),
               ("rm.mode.conv", 62, 85)]
KERNELS = [("gemm", 12, 19), ("cast", 22, 25), ("k2", 25, 45), ("k3", 62, 70), ("k4", 70, 85),
           ("cast", 90, 95), ("cast", 105, 108)]
CONV = {"k2", "k3", "k4"}


def test_span_split_by_hand():
    out = bench_spans.span_split(HOST, ANNOTATIONS, KERNELS, 0, 110,
                     lambda n: "conv" if n in CONV else n)
    s = {n: {k: (pytest.approx(v * 1e6) if isinstance(v, float) else v) for k, v in d.items()
             if k != "device_by_bucket"} for n, d in out["spans"].items()}
    # gaps [0,12) [19,22) [45,62) [85,90) [95,105) [108,110): at 0 no span,
    # at 19 the merge (inside the step), at 45, 85, 95 the step, at 108 the wait
    assert s == {"rm.step": {"n": 1, "host_s": 98, "device_s": 58, "idle_s": 32},
                 "rm.mode.merge": {"n": 1, "host_s": 10, "device_s": 7, "idle_s": 3},
                 "rm.mode.conv": {"n": 2, "host_s": 40, "device_s": 46, "idle_s": 0},
                 "rm.sampler.wait": {"n": 1, "host_s": 10, "device_s": 0, "idle_s": 2},
                 "(none)": {"idle_s": 12}}
    by_bucket = {k: v * 1e6 for k, v in out["spans"]["rm.mode.conv"]["device_by_bucket"].items()}
    assert by_bucket == pytest.approx({"cast": 3, "conv": 43})
    assert out["step_idle_s"] * 1e6 == pytest.approx(3 + 17 + 5 + 10)
    busy = 7 + 3 + 20 + 8 + 15 + 5 + 3
    assert sum(d["idle_s"] for d in out["spans"].values()) * 1e6 == pytest.approx(110 - busy)


def test_readings_a_unit():
    spans = {"rm.sampler.wait": {"host_s": 0.002}, "rm.loop.h2d": {"host_s": 0.010},
             "rm.mode.merge": {"device_s": 0.030}, "rm.mode.merge_bwd": {"device_s": 0.006},
             "rm.mode.conv": {"device_s": 0.5, "device_by_bucket": {"k2": 0.2, "cast": 0.1,
                                                                    "k4": 0.2}},
             "rm.reparam.prepare": {"host_s": 0.04}, "rm.predict.h2d": {"host_s": 0.06},
             "rm.predict.stitch": {"device_s": 0.008}}
    train = bench_spans.readings("train", 2, spans, 0.004, ("k2", "k3", "k4"))
    assert train == pytest.approx({"sampler_ms.train": 1, "h2d_ms.train": 5,
                                   "step_idle_ms.train": 2, "merge_fwd_ms.train": 15,
                                   "merge_bwd_ms.train": 3, "conv_glue_ms.train": 50})
    serve = bench_spans.readings("serve", 2, spans, 0.0, ())
    assert serve == pytest.approx({"prepare_ms.serve": 20, "h2d_ms.serve": 30,
                                   "stitch_ms.serve": 4})


def test_unet_readings_a_unit():
    """A plain U-Net's cell adds its two readings; its checks hold the conv
    buckets inside ``rm.unet.conv`` to at most their time in the window (the
    backward's convs run under no span) and read the glue of its own
    ``glue_ms.<config>.serve``."""
    spans = {"rm.unet.conv": {"device_s": 0.5, "idle_s": 0.0,
                              "device_by_bucket": {"cudnn_conv": 0.3, "copies": 0.2}},
             "rm.unet.bn": {"device_s": 0.1, "idle_s": 0.0}}
    train = bench_spans.readings("train", 2, spans, 0.0, ("cudnn_conv",))
    assert train["unet_conv_glue_ms.train"] == pytest.approx(100)
    assert train["unet_bn_ms.train"] == pytest.approx(50)
    serve = bench_spans.readings("serve", 2, spans, 0.0, ("cudnn_conv",))
    assert set(serve) == {"prepare_ms.serve", "h2d_ms.serve", "stitch_ms.serve",
                          "unet_conv_glue_ms.serve", "unet_bn_ms.serve"}
    trace = {"spans": {**spans, "rm.step": {"n": 2, "idle_s": 0.0},
                       "rm.loop.h2d": {"n": 2, "idle_s": 0.0}},
             "rm_kernels": 0, "window_s": 1.0, "busy_s": 1.0, "bucket_s": {"cudnn_conv": 0.9}}
    got = bench_spans.checks("train", 2, trace, {}, ("cudnn_conv",))
    assert got["unet_conv_within cudnn_conv"] == [0.3, 0.9, True]
    assert all(c[2] for c in got.values())
    trace["spans"] = {**spans, "rm.predict": {"n": 2, "idle_s": 0.0},
                      "rm.predict.h2d": {"n": 2, "idle_s": 0.0},
                      "rm.predict.stitch": {"device_s": 0.004, "idle_s": 0.0}}
    got = bench_spans.checks("serve", 2, trace, {"glue_ms.serve": 3.0}, ("cudnn_conv",))
    assert got["stitch_within_glue"] == [2.0, 3.0, True]


CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


@pytest.mark.parametrize("device,annotation,key,kernel", [
    (CUDA, False, "void conv3d_same_kernel<32, 16, false>", True),
    (CUDA, True, "rm.mode.conv", False),
    (CUDA, False, "ProfilerStep#1", False),
    (CPU, False, "aten::copy_", False)])
def test_profile_counts_no_span_as_a_kernel(device, annotation, key, kernel):
    event = SimpleNamespace(device_type=device, is_user_annotation=annotation, key=key)
    assert bench_profile._is_kernel(event) is kernel
