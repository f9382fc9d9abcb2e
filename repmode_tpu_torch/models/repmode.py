"""The RepMode MoDE U-Net as PyTorch modules.

Topology and parameter names are the reference's (fnet/nn_modules/RepMode.py:
8-214): four MoDE encoder blocks (1 -> 32 -> 64 -> 128 -> 256 channels at
mult_chan 32), a 256 -> 512 bottleneck of two MoDE convs, four MoDE decoder
blocks back to 32 and a final gate-only MoDE conv 32 -> 1. Because the names
and shapes are the reference's, a reference ``state_dict`` (``.p``
checkpoint) loads with ``strict=True``.

Activations are NDHWC at the public functions, as in the JAX package; the
parameters keep the reference's torch layouts and are viewed as DHWIO where
the ops need them.

Training mode (``net.train()``) is the JAX package's ``train=True``: BN
normalizes by batch statistics and updates its running stats, and each MoDE
conv runs the route ``cfg.train_impl`` names: 'auto' (or 'merged',
'merged_pallas') the per-sample merged kernels (``mode_conv_merged_persample``:
K2 forward, K3 dx, K4 dW on the card), 'expert_sum' the reference (its
shared-kernel convs through ``conv3d_same_autograd``). With ``cfg.remat`` the
train-mode MoDE conv op runs under ``torch.utils.checkpoint``. Eval mode
runs the expert sum with running-stat BN. The bf16 policy is the JAX
package's: in training a conv's output is rounded to the compute dtype before
BN, and every MoDE conv stores its post-ReLU output in the compute dtype.

With ``cfg.train_s2d`` (the default, as in JAX) the narrow levels
(``reparam.default_s2d_levels``: native width below 128, levels 1 and 2 at
mult_chan 32) run in the space-to-depth domain, in training and in eval
mode, as ``repmode_tpu/models/repmode.py`` runs them with its A/B switches
at their defaults: an encoder block converts at entry, keeps its skip in the
s2d domain and downsamples to the native next level
(``downsample_s2d_domain``); a decoder block upsamples into the s2d domain
(``upsample_to_s2d``), concatenates the skip first and converts back with
``depth_to_space_hw`` unless it is level 1, whose ``conv_out`` runs in the
s2d domain. BN there is phase-aware (``phases=4``). The MoDE convs of those
levels take the s2d routes of ``ops/mode.py``: the tap-major merged conv for
Co <= 4, else the merged route (K6 + K4 for the 4-lane entry conv, K2-K4 for
the rest) in training and the s2d expert sum in eval mode or under
'expert_sum'. Parameter names and shapes are the same in both layouts.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.device import DeviceLike, resolve_device
from repmode_tpu_torch.models.reparam import default_s2d_levels
from repmode_tpu_torch.ops.conv3d import downsample2x_conv, upsample2x_convt
from repmode_tpu_torch.ops.mode import (
    ExpertKernels,
    gate_logits_to_weights,
    mode_conv_expert_sum,
    mode_conv_expert_sum_s2d_domain,
    mode_conv_merged_persample,
    mode_conv_merged_s2d,
    mode_conv_tapmajor_merged_s2d,
)
from repmode_tpu_torch.ops.norm import batch_norm_apply, batch_norm_train
from repmode_tpu_torch.ops.s2d import (
    depth_to_space_hw,
    downsample_s2d_domain,
    s2d_down_kernel,
    space_to_depth_hw,
    upsample_to_s2d,
)

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def torch_uniform_init(
    shape: Sequence[int], fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch's kaiming_uniform_(a=sqrt(5))
    bound, the reference's gen_conv_kernel (RepMode.py:156-159) and the
    default Conv3d / Linear init. Drawn on the CPU from ``generator``."""
    bound = 1.0 / (fan_in**0.5)
    return torch.empty(tuple(shape)).uniform_(-bound, bound, generator=generator)


# train_impl -> the MoDE conv of the train-mode forward ('merged_pallas' is
# the JAX package's name for the per-sample kernels K2-K4 port)
_TRAIN_OPS = {
    "auto": mode_conv_merged_persample,
    "merged": mode_conv_merged_persample,
    "merged_pallas": mode_conv_merged_persample,
    "expert_sum": mode_conv_expert_sum,
}
# the same in the s2d domain
_TRAIN_OPS_S2D = {
    "auto": mode_conv_merged_s2d,
    "merged": mode_conv_merged_s2d,
    "merged_pallas": mode_conv_merged_s2d,
    "expert_sum": mode_conv_expert_sum_s2d_domain,
}


def _bn(x: torch.Tensor, bn: nn.BatchNorm3d, phases: int = 1) -> torch.Tensor:
    """Batch statistics in training mode (running stats updated), running
    statistics in eval mode; ``phases=4`` for an s2d tensor."""
    if bn.training:
        return batch_norm_train(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                momentum=bn.momentum, eps=bn.eps,
                                num_batches_tracked=bn.num_batches_tracked, phases=phases)
    return batch_norm_apply(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps,
                            phases=phases)


class MoDEConv(nn.Module):
    """One MoDE conv unit (reference MoDEConv, RepMode.py:123-214).

    ``s2d``: input and output are s2d-domain tensors (N,D,h',w',4C); the
    input is a concat of s2d segments of native widths
    ``input_channel_sizes`` (() = one segment)."""

    def __init__(
        self,
        num_experts: int,
        num_tasks: int,
        in_chan: int,
        out_chan: int,
        kernel_size: int = 5,
        conv_type: str = "normal",
        bn_momentum: float = 0.1,
        bn_eps: float = 1e-5,
        compute_dtype: Optional[torch.dtype] = None,
        generator: Optional[torch.Generator] = None,
        train_impl: str = "auto",
        s2d: bool = False,
        input_channel_sizes: tuple = (),
        remat: bool = False,
    ):
        super().__init__()
        if conv_type not in ("normal", "final"):
            raise ValueError(f"conv_type must be 'normal' or 'final', got {conv_type}")
        ci, co, e = in_chan, out_chan, num_experts
        self.num_experts, self.out_chan = e, co
        self.kernel_size = kernel_size
        self.conv_type = conv_type
        self.compute_dtype = compute_dtype
        self.train_impl = train_impl
        self.s2d = s2d
        self.remat = remat
        self.input_channel_sizes = tuple(input_channel_sizes)
        g = generator
        self.expert_conv5x5_conv = nn.Parameter(torch_uniform_init((co, ci, 5, 5, 5), ci * 125, g))
        self.expert_conv3x3_conv = nn.Parameter(torch_uniform_init((co, ci, 3, 3, 3), ci * 27, g))
        self.expert_conv1x1_conv = nn.Parameter(torch_uniform_init((co, ci, 1, 1, 1), ci, g))
        self.expert_avg3x3_conv = nn.Parameter(torch_uniform_init((co, ci, 1, 1, 1), ci, g))
        self.expert_avg5x5_conv = nn.Parameter(torch_uniform_init((co, ci, 1, 1, 1), ci, g))
        self.register_buffer("expert_avg3x3_pool", torch.full((3, 3, 3), 1.0 / 27.0))
        self.register_buffer("expert_avg5x5_pool", torch.full((5, 5, 5), 1.0 / 125.0))
        if conv_type == "normal":
            self.subsequent_layer = nn.Sequential(
                nn.BatchNorm3d(co, eps=bn_eps, momentum=bn_momentum), nn.ReLU()
            )
        self.gate = nn.utils.skip_init(nn.Linear, num_tasks, e * co)
        with torch.no_grad():
            self.gate.weight.copy_(torch_uniform_init((e * co, num_tasks), num_tasks, g))
            self.gate.bias.copy_(torch_uniform_init((e * co,), num_tasks, g))

    def experts(self) -> ExpertKernels:
        """The expert kernels as DHWIO views of the (Co,Ci,D,H,W) parameters."""
        return ExpertKernels(
            *(
                p.permute(2, 3, 4, 1, 0)
                for p in (
                    self.expert_conv5x5_conv, self.expert_conv3x3_conv,
                    self.expert_conv1x1_conv, self.expert_avg3x3_conv,
                    self.expert_avg5x5_conv,
                )
            )
        )

    def _op(self):
        """The MoDE conv this mode and domain run (JAX MoDEConv's dispatch)."""
        if self.training and self.train_impl not in _TRAIN_OPS:
            raise ValueError(f"train_impl must be one of {sorted(_TRAIN_OPS)}, "
                             f"got {self.train_impl!r}")
        if not self.s2d:
            return _TRAIN_OPS[self.train_impl] if self.training else mode_conv_expert_sum
        if self.out_chan <= 4:
            op = mode_conv_tapmajor_merged_s2d
        elif self.training:
            op = _TRAIN_OPS_S2D[self.train_impl]
        else:
            op = mode_conv_expert_sum_s2d_domain
        return functools.partial(op, channel_sizes=self.input_channel_sizes or None)

    def forward(self, x: torch.Tensor, task_emb: torch.Tensor) -> torch.Tensor:
        logits = F.linear(task_emb.to(self.gate.weight.dtype), self.gate.weight, self.gate.bias)
        g = gate_logits_to_weights(logits, self.num_experts, self.out_chan)
        op = self._op()
        if self.remat and self.training:
            # JAX's jax.checkpoint: the backward recomputes the gate merge and
            # the forward conv instead of keeping their intermediates
            y = checkpoint(op, x, self.experts(), g, compute_dtype=self.compute_dtype,
                           use_reentrant=False)
        else:
            y = op(x, self.experts(), g, compute_dtype=self.compute_dtype)
        if self.training and self.compute_dtype is not None:
            y = y.to(self.compute_dtype)  # conv output in bf16 before BN, as in JAX
        if self.conv_type == "normal":
            y = torch.relu(_bn(y, self.subsequent_layer[0], 4 if self.s2d else 1))
        if self.compute_dtype is not None:
            # consumers round to the compute dtype anyway; storing it halves memory
            y = y.to(self.compute_dtype)
        return y


class MoDESubNet2Conv(nn.Module):
    """Two stacked MoDE convs (reference MoDESubNet2Conv, RepMode.py:111-120);
    with ``s2d`` both run in the s2d domain and ``input_channel_sizes``
    describes conv1's concatenated input."""

    def __init__(self, num_experts, num_tasks, n_in, n_out, cfg: ModelConfig,
                 compute_dtype=None, generator=None, s2d=False, input_channel_sizes=()):
        super().__init__()
        common = dict(
            kernel_size=cfg.kernel_size, bn_momentum=cfg.bn_momentum, bn_eps=cfg.bn_eps,
            compute_dtype=compute_dtype, generator=generator, train_impl=cfg.train_impl,
            s2d=s2d, remat=cfg.remat,
        )
        self.conv1 = MoDEConv(num_experts, num_tasks, n_in, n_out,
                              input_channel_sizes=input_channel_sizes, **common)
        self.conv2 = MoDEConv(num_experts, num_tasks, n_out, n_out, **common)

    def forward(self, x, task_emb):
        return self.conv2(self.conv1(x, task_emb), task_emb)


def _resample_block(conv_cls, ci, co, fan_in, weight_shape, cfg, generator) -> nn.Sequential:
    """(k=2, s=2 conv, BN, ReLU) with the reference's names conv_down / convt."""
    conv = nn.utils.skip_init(conv_cls, ci, co, kernel_size=2, stride=2, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch_uniform_init(weight_shape, fan_in, generator))
    return nn.Sequential(conv, nn.BatchNorm3d(co, eps=cfg.bn_eps, momentum=cfg.bn_momentum),
                         nn.ReLU())


class MoDEEncoderBlock(nn.Module):
    """MoDE double conv -> skip, then k2s2 conv + BN + ReLU downsample
    (reference MoDEEncoderBlock, RepMode.py:74-89). With ``s2d`` the block
    converts its native input at entry, returns the skip in the s2d domain
    and downsamples to the native next level."""

    def __init__(self, num_experts, num_tasks, in_chan, out_chan, cfg: ModelConfig,
                 compute_dtype=None, generator=None, s2d=False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.s2d = s2d
        self.conv_more = MoDESubNet2Conv(num_experts, num_tasks, in_chan, out_chan, cfg,
                                         compute_dtype, generator, s2d=s2d)
        self.conv_down = _resample_block(
            nn.Conv3d, out_chan, out_chan, out_chan * 8, (out_chan, out_chan, 2, 2, 2),
            cfg, generator,
        )

    def forward(self, x, task_emb):
        if self.s2d:
            x = space_to_depth_hw(x)
        x_skip = self.conv_more(x, task_emb)
        w_down = self.conv_down[0].weight.permute(2, 3, 4, 1, 0)
        if self.s2d:
            x = downsample_s2d_domain(x_skip, s2d_down_kernel(w_down),
                                      compute_dtype=self.compute_dtype)
        else:
            x = downsample2x_conv(x_skip, w_down, compute_dtype=self.compute_dtype)
        return torch.relu(_bn(x, self.conv_down[1])), x_skip


class MoDEDecoderBlock(nn.Module):
    """k2s2 transposed conv + BN + ReLU, concat skip first, MoDE double conv
    (reference MoDEDecoderBlock, RepMode.py:92-108). With ``s2d`` the
    upsample emits the s2d domain, the skip arrives in it, and the output
    stays in it (the caller converts back where the next consumer is native)."""

    def __init__(self, num_experts, num_tasks, in_chan, out_chan, cfg: ModelConfig,
                 compute_dtype=None, generator=None, s2d=False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.s2d = s2d
        # torch ConvTranspose3d weight is (Ci, Co, k, k, k); its fan_in is
        # computed from dim 1, i.e. out_chan * k^3
        self.convt = _resample_block(
            nn.ConvTranspose3d, in_chan, out_chan, out_chan * 8, (in_chan, out_chan, 2, 2, 2),
            cfg, generator,
        )
        self.conv_less = MoDESubNet2Conv(
            num_experts, num_tasks, in_chan, out_chan, cfg, compute_dtype, generator, s2d=s2d,
            input_channel_sizes=(out_chan, out_chan) if s2d else ())

    def forward(self, x, x_skip, task_emb):
        w_up = self.convt[0].weight.permute(2, 3, 4, 0, 1)
        upsample = upsample_to_s2d if self.s2d else upsample2x_convt
        x = upsample(x, w_up, compute_dtype=self.compute_dtype)
        x = torch.relu(_bn(x, self.convt[1], 4 if self.s2d else 1))
        dt = torch.promote_types(x_skip.dtype, x.dtype)
        x = torch.cat([x_skip.to(dt), x.to(dt)], dim=-1)  # skip first (RepMode.py:106)
        return self.conv_less(x, task_emb)


class RepModeNet(nn.Module):
    """Task-conditioned MoDE U-Net (reference Net, RepMode.py:8-71).

    ``forward(x, task_id)``: x (N,D,H,W,Cin), task_id (N,) int ->
    (N,D,H,W,Cout) fp32 (fp64 for an fp64 net), in training or eval mode.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        num_tasks: int,
        compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype}")
        cdt = _DTYPES[compute_dtype]
        self.cfg, self.num_tasks = cfg, num_tasks
        e, t, c = cfg.num_experts, num_tasks, cfg.in_channels * cfg.mult_chan
        chans = [c * 2**i for i in range(cfg.depth + 1)]
        # the space-to-depth levels (JAX RepModeNet, repmode.py:411-417)
        self.s2d_levels = default_s2d_levels(cfg) if cfg.train_s2d else ()
        in_ch = cfg.in_channels
        for i in range(1, cfg.depth + 1):
            setattr(self, f"encoder_block{i}", MoDEEncoderBlock(
                e, t, in_ch, chans[i - 1], cfg, cdt, generator, s2d=i in self.s2d_levels))
            in_ch = chans[i - 1]
        self.bottle_block = MoDESubNet2Conv(
            e, t, chans[cfg.depth - 1], chans[cfg.depth], cfg, cdt, generator)
        for i in range(cfg.depth, 0, -1):
            setattr(self, f"decoder_block{i}", MoDEDecoderBlock(
                e, t, chans[i], chans[i - 1], cfg, cdt, generator, s2d=i in self.s2d_levels))
        self.conv_out = MoDEConv(
            e, t, c, cfg.out_channels, kernel_size=cfg.kernel_size, conv_type="final",
            compute_dtype=cdt, generator=generator, train_impl=cfg.train_impl,
            s2d=1 in self.s2d_levels, remat=cfg.remat,
        )
        self.to(dev)

    def forward(self, x: torch.Tensor, task_id: torch.Tensor) -> torch.Tensor:
        task_emb = F.one_hot(task_id.long(), self.num_tasks)
        skips = []
        for i in range(1, self.cfg.depth + 1):
            x, x_skip = getattr(self, f"encoder_block{i}")(x, task_emb)
            skips.append(x_skip)
        x = self.bottle_block(x, task_emb)
        for i in range(self.cfg.depth, 0, -1):
            x = getattr(self, f"decoder_block{i}")(x, skips[i - 1], task_emb)
            if i > 1 and i in self.s2d_levels:  # level 1's output feeds the s2d conv_out
                x = depth_to_space_hw(x)
        y = self.conv_out(x, task_emb)
        if self.conv_out.s2d:
            y = depth_to_space_hw(y)
        return y.to(torch.promote_types(y.dtype, torch.float32))
