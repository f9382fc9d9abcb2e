"""The port's tracing: named spans and optional ``torch.profiler`` traces.

The port of ``repmode_tpu.utils.timing``. ``span`` names a region of the
program in a running profiler's trace: a ``torch.profiler.record_function``
range ``rm.<name>``, on the host and, around the kernels launched inside it,
on the device's timeline, on the same clock as the kernels. With no profiler
recording it is a shared null context, so the program pays one check of a
bool a span. ``profile_trace`` records a trace of a region
(``train/loop.run_experiment(..., profile_dir=...)`` wraps the first trained
epoch in it).

The spans, at the layer boundaries of the two paths:

  rm.sampler.wait     data/sampler: the consumer's wait for its next batch
  rm.loop.h2d         train/loop.run_train_epoch: the batch's pinned copy to the card
  rm.step             train/step: the whole train step
  rm.mode.merge       ops/mode: the gate merge of a merged route (the
                      training route's kernel; the s2d routes' bank and einsum)
  rm.mode.merge_bwd   ops/mode: the training route's gate-merge backward
  rm.mode.conv        ops/mode: the casts and the conv of a MoDE conv, in the
                      forward and in the hand-written backwards
  rm.unet.conv        models/unet: a plain U-Net's 'same' conv (UNet,
                      fnet_nn_3d) with its casts and bias, in the forward
  rm.unet.bn          models/unet: a plain U-Net's BN and ReLU, in the forward
  rm.reparam.prepare  models/reparam: a task's re-parameterization
  rm.predict          infer/predict: one volume
  rm.predict.h2d      infer/predict: the volume's copy to the card
  rm.predict.stitch   infer/predict: a batch's gather of patches, its blend
                      into the sums, and the final divide

A span opened in a plain Python thread is not recorded (the sampler's
prefetch thread has none); one opened in a custom ``autograd.Function``'s
backward is, since autograd carries the profiler's state to its threads.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "rm."
_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[object] = None):
    """A ``record_function`` range ``rm.<name>`` (``args``, if any, as its
    string argument) while a profiler records; else a shared null context."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name, None if args is None else str(args))


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the region into ``log_dir`` (a
    no-op when None): the CPU's activity and, where a card is present, the
    card's, written at the region's end as a Chrome trace
    ``<host>_<pid>.<time>.pt.trace.json``, one file a process."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
