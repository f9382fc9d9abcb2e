"""Whole-network structural re-parameterization for inference, native layout.

The gate input is a one-hot task embedding, so each MoDE conv has exactly
``num_tasks`` distinct merged kernels. They are merged once per task, and
eval-mode BatchNorm (an affine map) is folded into the kernel and a bias:

    BN(conv(x, w)) = conv(x, w * s) + (beta - mu * s),  s = gamma / sqrt(var + eps)

The result is a plain net of 18 conv+bias+ReLU layers, four k2s2
downsamples, four k2s2 transposed upsamples, four concats and a final conv
(``plain_forward``). Every 'same' conv of it is one ``conv3d_same`` call,
which on the card is one launch of the hand-written kernel with its fused
bias+ReLU epilogue.

Weights are read from a reference-layout ``state_dict`` (the port's
``RepModeNet.state_dict()`` or a reference checkpoint); the returned plain
params are DHWIO tensors in the JAX package's tree layout.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.ops.conv3d import conv3d_same, downsample2x_conv, upsample2x_convt
from repmode_tpu_torch.ops.mode import ExpertKernels, expert_bank, gate_logits_to_weights

Params = Dict[str, Any]
StateDict = Mapping[str, torch.Tensor]

_EXPERT_NAMES = (
    "expert_conv5x5_conv", "expert_conv3x3_conv", "expert_conv1x1_conv",
    "expert_avg3x3_conv", "expert_avg5x5_conv",
)
_COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _sub(state: StateDict, prefix: str) -> Dict[str, torch.Tensor]:
    """Entries under ``prefix.``, with the prefix removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in state.items() if k.startswith(prefix + ".")}


def merged_kernel_for_task(
    conv_state: StateDict, task_onehot: torch.Tensor, num_experts: int, kernel_size: int = 5
) -> torch.Tensor:
    """Merge one MoDE conv's experts for a single task -> (k,k,k,Ci,Co).

    ``conv_state`` holds the conv's reference entries (``expert_*``,
    ``gate.weight``, ``gate.bias``).
    """
    gw, gb = conv_state["gate.weight"], conv_state["gate.bias"]
    logits = task_onehot.to(gw.dtype) @ gw.T + gb
    co = conv_state["expert_conv5x5_conv"].shape[0]
    g = gate_logits_to_weights(logits[None], num_experts, co)[0]  # (E, Co)
    ek = ExpertKernels(*(conv_state[n].permute(2, 3, 4, 1, 0) for n in _EXPERT_NAMES))
    bank = expert_bank(ek, kernel_size)
    return torch.einsum("eo,edhwio->dhwio", g.to(bank.dtype), bank)


def fold_bn(w: torch.Tensor, bn_state: StateDict, eps: float):
    """Fold eval-mode BN into (w, bias). w: (..., Co); BN entries (Co,)."""
    s = bn_state["weight"] / torch.sqrt(bn_state["running_var"] + eps)
    return w * s, bn_state["bias"] - bn_state["running_mean"] * s


@torch.no_grad()
def reparameterize(state: StateDict, cfg: ModelConfig, num_tasks: int, task_id: int) -> Params:
    """Reference-layout state_dict -> plain inference params for one task.

      encoder_block{i}: conv1_w/b, conv2_w/b, down_w/b
      bottle_block:     conv1_w/b, conv2_w/b
      decoder_block{i}: up_w/b, conv1_w/b, conv2_w/b
      conv_out_w        (no bias: the final MoDE conv has no BN)
    """
    any_t = next(iter(state.values()))
    onehot = F.one_hot(torch.tensor(task_id, device=any_t.device), num_tasks)
    e, ks, eps = cfg.num_experts, cfg.kernel_size, cfg.bn_eps

    def subnet(prefix):
        out = {}
        for conv in ("conv1", "conv2"):
            cs = _sub(state, f"{prefix}.{conv}")
            w = merged_kernel_for_task(cs, onehot, e, ks)
            out[f"{conv}_w"], out[f"{conv}_b"] = fold_bn(w, _sub(cs, "subsequent_layer.0"), eps)
        return out

    out: Params = {}
    for i in range(1, cfg.depth + 1):
        blk = subnet(f"encoder_block{i}.conv_more")
        down_w = state[f"encoder_block{i}.conv_down.0.weight"].permute(2, 3, 4, 1, 0)
        blk["down_w"], blk["down_b"] = fold_bn(
            down_w, _sub(state, f"encoder_block{i}.conv_down.1"), eps)
        out[f"encoder_block{i}"] = blk
    out["bottle_block"] = subnet("bottle_block")
    for i in range(cfg.depth, 0, -1):
        blk = subnet(f"decoder_block{i}.conv_less")
        up_w = state[f"decoder_block{i}.convt.0.weight"].permute(2, 3, 4, 0, 1)
        blk["up_w"], blk["up_b"] = fold_bn(up_w, _sub(state, f"decoder_block{i}.convt.1"), eps)
        out[f"decoder_block{i}"] = blk
    out["conv_out_w"] = merged_kernel_for_task(_sub(state, "conv_out"), onehot, e, ks)
    return out


def reparameterize_all_tasks(state: StateDict, cfg: ModelConfig, num_tasks: int) -> Params:
    """Per-task plain params stacked along a leading task axis."""
    trees = [reparameterize(state, cfg, num_tasks, t) for t in range(num_tasks)]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes, dim=0)

    return stack(trees)


def plain_forward(
    plain: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Run the re-parameterized net. x: (N,D,H,W,Cin) -> (N,D,H,W,Cout).

    Each conv rounds its input to ``compute_dtype``. A conv+bias+ReLU output
    is stored in the compute dtype: every consumer (next conv, concat into a
    conv, down/upsample) rounds to it first, so the values are the same as
    keeping fp32. The final conv's output stays fp32.
    """
    cdt = compute_dtype

    def cbr(h, w, b):
        return conv3d_same(h, w, b, relu=True, compute_dtype=cdt, out_dtype=cdt)

    def run_subnet(h, blk):
        return cbr(cbr(h, blk["conv1_w"], blk["conv1_b"]), blk["conv2_w"], blk["conv2_b"])

    skips = []
    h = x
    for i in range(1, cfg.depth + 1):
        blk = plain[f"encoder_block{i}"]
        skip = run_subnet(h, blk)
        skips.append(skip)
        h = torch.relu(downsample2x_conv(skip, blk["down_w"], compute_dtype=cdt) + blk["down_b"])

    h = run_subnet(h, plain["bottle_block"])

    for i in range(cfg.depth, 0, -1):
        blk = plain[f"decoder_block{i}"]
        up = torch.relu(upsample2x_convt(h, blk["up_w"], compute_dtype=cdt) + blk["up_b"])
        skip = skips[i - 1]
        dt = torch.promote_types(skip.dtype, up.dtype) if cdt is None else cdt
        h = run_subnet(torch.cat([skip.to(dt), up.to(dt)], dim=-1), blk)

    return conv3d_same(h, plain["conv_out_w"], compute_dtype=cdt)


def make_inference(cfg) -> tuple:
    """(prepare, forward) for the top-level Config ``cfg``.

    prepare(state_dict, task_id) -> plain params (on the state's device);
    forward(plain, x) -> prediction. Native NDHWC only.
    """
    if cfg.model.name != "RepMode":
        raise NotImplementedError(
            f"model {cfg.model.name!r}: only RepMode is ported to repmode_tpu_torch yet"
        )
    if cfg.eval.s2d:
        raise NotImplementedError(
            "cfg.eval.s2d=True: space-to-depth execution is not ported (A11); "
            "the port runs native NDHWC, set eval.s2d=False"
        )
    if cfg.train.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")
    cdt = _COMPUTE_DTYPES[cfg.train.compute_dtype]
    num_tasks = cfg.num_tasks

    def prepare(state: StateDict, task_id: int) -> Params:
        return reparameterize(state, cfg.model, num_tasks, task_id)

    return prepare, functools.partial(plain_forward, cfg=cfg.model, compute_dtype=cdt)
