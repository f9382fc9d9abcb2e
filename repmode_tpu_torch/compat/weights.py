"""Carry RepMode and UNet weights between the reference layout and the JAX layout.

The port's modules use the reference's ``state_dict`` names and torch
layouts, so a reference ``.p`` checkpoint loads as it is. ``from_jax_variables``
turns the JAX package's ``{'params', 'batch_stats'}`` tree (as numpy arrays)
into such a ``state_dict``; it is the exact inverse of
``repmode_tpu.compat.torch_import.convert_state_dict``:

  DHWIO (D,H,W,Ci,Co)          -> conv3d weight  (Co,Ci,D,H,W)
  DHWIO (D,H,W,Ci,Co) of up_w  -> convT3d weight (Ci,Co,D,H,W)
  gate_kernel (In, Out)        -> Linear weight  (Out, In)
  bn/{scale,bias} + batch_stats/bn/{mean,var} -> BatchNorm3d entries

A UNet tree (``unet_from_jax_variables``) maps the same way onto
``models/unet.UNet3D``'s names: flax's ``BatchNorm3d_0`` of a ``ConvBNReLU``
is its ``bn``; ``from_jax_variables`` dispatches on the tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_EXPERTS = {
    "w5": "expert_conv5x5_conv",
    "w3": "expert_conv3x3_conv",
    "w1": "expert_conv1x1_conv",
    "wa3": "expert_avg3x3_conv",
    "wa5": "expert_avg5x5_conv",
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _conv_w(a) -> torch.Tensor:
    """(D,H,W,Ci,Co) -> (Co,Ci,D,H,W)."""
    return _t(np.transpose(np.asarray(a), (4, 3, 0, 1, 2)))


def _convt_w(a) -> torch.Tensor:
    """(D,H,W,Ci,Co) -> (Ci,Co,D,H,W)."""
    return _t(np.transpose(np.asarray(a), (3, 4, 0, 1, 2)))


def _bn(out: Dict[str, torch.Tensor], prefix: str, params: Mapping,
        stats: Optional[Mapping]) -> None:
    out[f"{prefix}.weight"] = _t(params["scale"])
    out[f"{prefix}.bias"] = _t(params["bias"])
    if stats is not None:
        out[f"{prefix}.running_mean"] = _t(stats["mean"])
        out[f"{prefix}.running_var"] = _t(stats["var"])
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _mode_conv(out, prefix: str, p: Mapping, s: Optional[Mapping]) -> None:
    dtype = np.asarray(p["w5"]).dtype
    for k, name in _EXPERTS.items():
        out[f"{prefix}.{name}"] = _conv_w(p[k])
    if s is not None:
        out[f"{prefix}.expert_avg3x3_pool"] = _t(np.full((3, 3, 3), 1.0 / 27.0, dtype))
        out[f"{prefix}.expert_avg5x5_pool"] = _t(np.full((5, 5, 5), 1.0 / 125.0, dtype))
    if "bn" in p:
        _bn(out, f"{prefix}.subsequent_layer.0", p["bn"], None if s is None else s["bn"])
    out[f"{prefix}.gate.weight"] = _t(np.asarray(p["gate_kernel"]).T)
    out[f"{prefix}.gate.bias"] = _t(p["gate_bias"])


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> reference state_dict.

    ``num_batches_tracked`` is not part of the JAX tree and comes back as 0;
    the fixed pool buffers are rebuilt as constants. A params-only tree (no
    'params' key at the top, e.g. JAX gradients) maps to the parameter
    entries alone: no buffers.
    """
    params, stats = _split(variables)
    if not any(k in ("bottle_block", "conv_out") or k.startswith(("encoder_block",
                                                                    "decoder_block"))
               for k in params):
        return unet_from_jax_variables(variables)

    def sub(tree, *keys):
        for k in keys:
            tree = None if tree is None else tree[k]
        return tree

    out: Dict[str, torch.Tensor] = {}
    for top, p in params.items():
        s = None if stats is None else stats.get(top, {})
        if top.startswith("encoder_block"):
            for conv in ("conv1", "conv2"):
                _mode_conv(out, f"{top}.conv_more.{conv}", p["conv_more"][conv],
                           sub(s, "conv_more", conv))
            out[f"{top}.conv_down.0.weight"] = _conv_w(p["down_w"])
            _bn(out, f"{top}.conv_down.1", p["down_bn"], sub(s, "down_bn"))
        elif top == "bottle_block":
            for conv in ("conv1", "conv2"):
                _mode_conv(out, f"{top}.{conv}", p[conv], sub(s, conv))
        elif top.startswith("decoder_block"):
            out[f"{top}.convt.0.weight"] = _convt_w(p["up_w"])
            _bn(out, f"{top}.convt.1", p["up_bn"], sub(s, "up_bn"))
            for conv in ("conv1", "conv2"):
                _mode_conv(out, f"{top}.conv_less.{conv}", p["conv_less"][conv],
                           sub(s, "conv_less", conv))
        elif top == "conv_out":
            _mode_conv(out, top, p, s)
        else:
            raise KeyError(f"unexpected top-level module {top!r}")
    return out


def _split(variables: Mapping[str, Any]):
    """(params, batch_stats or None) of a variables tree or a params-only tree."""
    if "params" in variables:
        return variables["params"], variables["batch_stats"]
    return variables, None


def unet_from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX UNet3D ``{'params', 'batch_stats'}`` (numpy leaves) -> ``UNet3D``
    state_dict; a params-only tree maps to the parameter entries alone."""
    params, stats = _split(variables)
    out: Dict[str, torch.Tensor] = {}
    for top, p in params.items():
        s = None if stats is None else stats.get(top)
        if top.endswith(("_conv1", "_conv2")):
            out[f"{top}.w"] = _conv_w(p["w"])
            _bn(out, f"{top}.bn", p["BatchNorm3d_0"], None if s is None else s["BatchNorm3d_0"])
        elif top.endswith("_bn"):
            _bn(out, top, p, s)
        elif top.startswith("up") and top.endswith("_w"):
            out[top] = _convt_w(p)
        elif top.startswith("down") or top == "out_w":
            out[top] = _conv_w(p)
        else:
            raise KeyError(f"unexpected top-level UNet entry {top!r}")
    return out


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference ``.p`` checkpoint (fnet_model.py:57-82).

    Returns {'state_dict', 'optimizer_state', 'count_iter', 'count_epoch',
    'adopted_datasets'} with the task list sorted as the reference sorts it,
    or None when the file is a bare state_dict. fp16 (AMP-trained) tensors are widened to
    fp32. The file is unpickled in full, so load only checkpoints you trust.
    """
    state = torch.load(path, map_location="cpu", weights_only=False)
    if "nn_state" in state:
        sd, opts = state["nn_state"], state.get("opts")
        out = {
            "optimizer_state": state.get("optimizer_state"),
            "count_iter": state.get("count_iter", 0),
            "count_epoch": state.get("count_epoch", 0),
            "adopted_datasets": sorted(getattr(opts, "adopted_datasets", []) or []) or None,
        }
    else:
        sd = state
        out = {"optimizer_state": None, "count_iter": 0, "count_epoch": 0,
               "adopted_datasets": None}
    out["state_dict"] = {
        k: (v.float() if v.dtype == torch.float16 else v) for k, v in sd.items()
    }
    return out
