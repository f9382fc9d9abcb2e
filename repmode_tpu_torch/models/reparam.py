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

Two more routes run the same function with the narrow levels in the
space-to-depth (s2d) domain of ``ops/s2d.py`` (``cfg.eval.s2d``, the JAX
package's eval default): ``plain_forward_s2d`` runs every 'same' conv on K1 at
s2d shapes, and ``plain_forward_s2d_pallas`` (``cfg.eval.pallas_conv``) keeps
the s2d levels' activations depth-padded and runs their chained convs on K5
(``conv3d_dpad``). On this card the s2d convs do 1.44x the native
arithmetic (structured zeros), so the port's CLI keeps the native route.

Weights are read from a reference-layout ``state_dict`` (the port's
``RepModeNet.state_dict()`` or a reference checkpoint); the returned plain
params are DHWIO tensors in the JAX package's tree layout.
"""

from __future__ import annotations

import functools
import logging
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.ops.conv3d import (
    conv3d_dpad,
    conv3d_same,
    conv3d_same_tapmajor,
    downsample2x_conv,
    upsample2x_convt,
)
from repmode_tpu_torch.ops.mode import ExpertKernels, expert_bank, gate_logits_to_weights
from repmode_tpu_torch.ops.s2d import (
    depth_to_space_hw,
    downsample_s2d_domain,
    downsample_s2d_to_s2d,
    s2d_bias,
    s2d_conv_kernel,
    s2d_down_kernel,
    space_to_depth_hw,
    upsample_s2d_to_s2d,
    upsample_to_s2d,
)

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


# ---------------------------------------------------- space-to-depth routes


def default_s2d_levels(cfg: ModelConfig) -> tuple:
    """Levels whose native channel width is below 128 (the JAX package's
    choice, made for the TPU's 128 lanes; kept so the routes match)."""
    c = cfg.in_channels * cfg.mult_chan
    return tuple(i for i in range(1, cfg.depth + 1) if c * 2 ** (i - 1) < 128)


@torch.no_grad()
def to_s2d_plain(plain: Params, cfg: ModelConfig, s2d_levels: tuple) -> Params:
    """Transform plain params for s2d execution of ``s2d_levels``.

    Pure weight reshuffles, once per task. A decoder conv1 kernel is split
    into its skip and upsample input halves, each transformed on its own:
    the runtime concatenates two s2d-domain tensors (phase blocks per
    source), not the s2d of the native concat.
    """
    out = dict(plain)
    for i in s2d_levels:
        enc = dict(plain[f"encoder_block{i}"])
        for conv in ("conv1", "conv2"):
            enc[f"{conv}_w"] = s2d_conv_kernel(enc[f"{conv}_w"])
            enc[f"{conv}_b"] = s2d_bias(enc[f"{conv}_b"])
        enc["down_w"] = s2d_down_kernel(enc["down_w"])
        out[f"encoder_block{i}"] = enc

        dec = dict(plain[f"decoder_block{i}"])
        w1 = dec["conv1_w"]
        half = w1.shape[3] // 2
        dec["conv1_w"] = torch.cat(
            [s2d_conv_kernel(w1[:, :, :, :half]), s2d_conv_kernel(w1[:, :, :, half:])], dim=3)
        dec["conv1_b"] = s2d_bias(dec["conv1_b"])
        dec["conv2_w"] = s2d_conv_kernel(dec["conv2_w"])
        dec["conv2_b"] = s2d_bias(dec["conv2_b"])
        out[f"decoder_block{i}"] = dec
    if 1 in s2d_levels:
        out["conv_out_w"] = s2d_conv_kernel(plain["conv_out_w"])
    return out


def plain_forward_s2d(
    plain: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    s2d_levels: tuple,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``plain_forward`` with ``s2d_levels`` run in the s2d domain.

    ``plain`` comes from ``to_s2d_plain`` with the same levels. Every 'same'
    conv is one K1 call, as in ``plain_forward``. Between consecutive s2d
    levels the downsample emits the next level's s2d domain directly and
    the upsample reads and writes s2d. At an s2d decoder level conv1 reads
    the skip and the upsample in place as two K1 calls whose fp32 sums are
    added (conv(cat(a, b), W) = conv(a, W_a) + conv(b, W_b)). The Co=4
    s2d ``conv_out`` is the tap-major matmul. These are the JAX package's
    default eval graph (its ``REPMODE_EVAL_DOWNS2D`` and
    ``REPMODE_EVAL_SPLITCAT`` switches at "1"); the port reads no
    environment variable.
    """
    cdt = compute_dtype
    s2d = set(s2d_levels)

    def cbr(h, w, b):
        return conv3d_same(h, w, b, relu=True, compute_dtype=cdt, out_dtype=cdt)

    def run_subnet(h, blk):
        return cbr(cbr(h, blk["conv1_w"], blk["conv1_b"]), blk["conv2_w"], blk["conv2_b"])

    skips = {}
    h = x
    h_in_s2d = False
    for i in range(1, cfg.depth + 1):
        blk = plain[f"encoder_block{i}"]
        if i in s2d:
            skip2 = run_subnet(h if h_in_s2d else space_to_depth_hw(h), blk)
            skips[i] = skip2
            h_in_s2d = (i + 1) in s2d
            if h_in_s2d:
                down = downsample_s2d_to_s2d(skip2, blk["down_w"], compute_dtype=cdt)
                h = torch.relu(down + s2d_bias(blk["down_b"]))
            else:
                down = downsample_s2d_domain(skip2, blk["down_w"], compute_dtype=cdt)
                h = torch.relu(down + blk["down_b"])
        else:
            skips[i] = run_subnet(h, blk)
            h = torch.relu(downsample2x_conv(skips[i], blk["down_w"], compute_dtype=cdt)
                           + blk["down_b"])
            h_in_s2d = False

    h = run_subnet(h, plain["bottle_block"])

    h_is_s2d = False
    for i in range(cfg.depth, 0, -1):
        blk = plain[f"decoder_block{i}"]
        if i in s2d:
            up_fn = upsample_s2d_to_s2d if h_is_s2d else upsample_to_s2d
            up2 = torch.relu(up_fn(h, blk["up_w"], compute_dtype=cdt) + s2d_bias(blk["up_b"]))
            ca = skips[i].shape[-1]
            w1 = blk["conv1_w"]
            y1 = torch.relu(
                conv3d_same(skips[i], w1[:, :, :, :ca], compute_dtype=cdt)
                + conv3d_same(up2, w1[:, :, :, ca:], blk["conv1_b"], compute_dtype=cdt))
            h = cbr(y1, blk["conv2_w"], blk["conv2_b"])
            h_is_s2d = True
        else:
            if h_is_s2d:  # an s2d level below a native one (levels not starting at 1)
                h = depth_to_space_hw(h)
                h_is_s2d = False
            up = torch.relu(upsample2x_convt(h, blk["up_w"], compute_dtype=cdt) + blk["up_b"])
            skip = skips[i]
            dt = torch.promote_types(skip.dtype, up.dtype) if cdt is None else cdt
            h = run_subnet(torch.cat([skip.to(dt), up.to(dt)], dim=-1), blk)

    if 1 in s2d:
        return depth_to_space_hw(conv3d_same_tapmajor(h, plain["conv_out_w"], compute_dtype=cdt))
    return conv3d_same(h, plain["conv_out_w"], compute_dtype=cdt)


def pallas_geometry_ok(cfg: ModelConfig) -> bool:
    """Whether the K5 chain (``conv3d_dpad``) takes this model's geometry:
    3x3 H/W taps after the s2d transform (native kernel_size 5) and s2d
    channel counts that are multiples of 128 (mult_chan % 32 == 0)."""
    return cfg.kernel_size == 5 and cfg.mult_chan % 32 == 0


def plain_forward_s2d_pallas(
    plain: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    s2d_levels: tuple,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``plain_forward_s2d`` with the s2d levels' convs as K5 chains.

    The same function, another execution: inside an s2d level the
    activations stay depth-padded (``(kD-1)/2`` zero rows at each depth
    edge) and each chained conv is one ``conv3d_dpad`` call (fused
    bias+ReLU, bf16 out, halo rows rewritten as zeros), so conv1 -> conv2
    pays no pad or slice pass. The level's entry pads depth once; the
    downsample trims the halo as a view; the decoder's upsample is padded
    once before its concat with the padded skip. ``encoder_block1.conv1``
    (4 s2d input channels), the non-s2d levels and ``conv_out`` run on K1;
    ``conv_out`` reads the trimmed padded tensor as a 'same' conv, which is
    the JAX route's VALID-in-depth conv over the padded rows, since the halo
    rows are zero. Computes in bf16 when ``compute_dtype`` is None, as the
    JAX route does.
    """
    cdt = compute_dtype or torch.bfloat16
    s2d = set(s2d_levels)
    pd = (cfg.kernel_size - 1) // 2

    def pad_d(h2):
        return F.pad(h2.to(cdt), (0, 0, 0, 0, 0, 0, pd, pd))

    def dpad_ok(w):
        return w.shape[1] == 3 and w.shape[2] == 3 and w.shape[3] % 128 == 0 \
            and w.shape[4] % 128 == 0

    def cbr(h, w, b):
        return conv3d_same(h, w, b, relu=True, compute_dtype=cdt, out_dtype=cdt)

    def dpad(xp, w, b):
        return conv3d_dpad(xp, w, b, relu=True, compute_dtype=cdt)

    def chain_from_padded(xp, blk):
        """s2d double conv: padded input -> padded bf16 output."""
        return dpad(dpad(xp, blk["conv1_w"], blk["conv1_b"]), blk["conv2_w"], blk["conv2_b"])

    def chain_from_native(h2, blk):
        """s2d double conv: native-depth input -> padded bf16 output."""
        if dpad_ok(blk["conv1_w"]):
            return chain_from_padded(pad_d(h2), blk)
        y1p = pad_d(cbr(h2, blk["conv1_w"], blk["conv1_b"]))  # encoder_block1.conv1
        return dpad(y1p, blk["conv2_w"], blk["conv2_b"])

    skips = {}
    h = x
    for i in range(1, cfg.depth + 1):
        blk = plain[f"encoder_block{i}"]
        if i in s2d:
            skips[i] = chain_from_native(space_to_depth_hw(h), blk)  # kept padded
            down = downsample_s2d_domain(skips[i], blk["down_w"], compute_dtype=cdt,
                                         trim_d_halo=pd)
        else:
            skips[i] = cbr(cbr(h, blk["conv1_w"], blk["conv1_b"]), blk["conv2_w"],
                           blk["conv2_b"])
            down = downsample2x_conv(skips[i], blk["down_w"], compute_dtype=cdt)
        h = torch.relu(down + blk["down_b"])

    blk = plain["bottle_block"]
    h = cbr(cbr(h, blk["conv1_w"], blk["conv1_b"]), blk["conv2_w"], blk["conv2_b"])

    for i in range(cfg.depth, 0, -1):
        blk = plain[f"decoder_block{i}"]
        up = torch.relu(upsample2x_convt(h, blk["up_w"], compute_dtype=cdt) + blk["up_b"])
        if i in s2d:
            cat_p = torch.cat([skips[i], pad_d(space_to_depth_hw(up))], dim=-1)
            h2 = chain_from_padded(cat_p, blk)[:, pd:-pd]
            if i == 1:
                y = conv3d_same(h2, plain["conv_out_w"], compute_dtype=cdt)
                return depth_to_space_hw(y)
            h = depth_to_space_hw(h2)
        else:
            cat = torch.cat([skips[i], up.to(cdt)], dim=-1)
            h = cbr(cbr(cat, blk["conv1_w"], blk["conv1_b"]), blk["conv2_w"], blk["conv2_b"])

    return conv3d_same(h, plain["conv_out_w"], compute_dtype=cdt)


def _make_plain_inference(cfg) -> tuple:
    """(prepare, forward) of a non-MoDE model (the UNet baseline), which has
    nothing to merge: prepare loads the state into an eval-mode net of
    ``cfg.model.name`` on the state's device, whatever the task; forward runs
    it under ``torch.no_grad()``, so on the card every 'same' conv is K1.
    The net is built once per device (its random init costs ~1 s at full
    width) and every prepare call reloads it, so a net that prepare returned
    holds the state of the latest call."""
    from repmode_tpu_torch.models import build_model

    nets: Dict[torch.device, torch.nn.Module] = {}

    def prepare(state: StateDict, task_id: int) -> torch.nn.Module:
        del task_id
        dev = next(iter(state.values())).device
        if dev not in nets:
            nets[dev] = build_model(cfg, device=dev).eval()
        nets[dev].load_state_dict(state, strict=True)
        return nets[dev]

    def forward(net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(x)

    return prepare, forward


def make_inference(cfg) -> tuple:
    """(prepare, forward) for the top-level Config ``cfg``.

    prepare(state_dict, task_id) -> plain params (on the state's device),
    s2d-transformed when ``cfg.eval.s2d``; forward(plain, x) -> prediction.
    The route: native ``plain_forward`` (``eval.s2d=False``);
    ``plain_forward_s2d`` (``eval.s2d=True``); ``plain_forward_s2d_pallas``
    (``eval.s2d=True, eval.pallas_conv=True``). A model geometry that K5
    does not take (``pallas_geometry_ok``) logs a warning and takes the
    ``plain_forward_s2d`` route, as in the JAX package: a choice of route
    made once here, not a fallback of the kernel. A model other than RepMode
    (the UNet) serves its eval-mode net as it is (``_make_plain_inference``).
    """
    if cfg.model.name != "RepMode":
        return _make_plain_inference(cfg)
    if cfg.train.compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")
    cdt = _COMPUTE_DTYPES[cfg.train.compute_dtype]
    num_tasks = cfg.num_tasks
    levels = default_s2d_levels(cfg.model) if cfg.eval.s2d else ()

    def prepare(state: StateDict, task_id: int) -> Params:
        p = reparameterize(state, cfg.model, num_tasks, task_id)
        return to_s2d_plain(p, cfg.model, levels) if levels else p

    use_dpad = bool(levels) and cfg.eval.pallas_conv
    if use_dpad and not pallas_geometry_ok(cfg.model):
        logging.getLogger("repmode_tpu_torch").warning(
            "eval.pallas_conv=True but the model geometry (kernel_size=%d, mult_chan=%d) is "
            "outside the K5 kernel's support (needs kernel_size=5 -> 3x3 s2d taps, "
            "mult_chan %% 32 == 0 -> s2d channels %% 128 == 0); taking the XLA s2d route",
            cfg.model.kernel_size, cfg.model.mult_chan,
        )
        use_dpad = False
    if use_dpad:
        forward = functools.partial(plain_forward_s2d_pallas, cfg=cfg.model, s2d_levels=levels,
                                    compute_dtype=cdt)
    elif levels:
        forward = functools.partial(plain_forward_s2d, cfg=cfg.model, s2d_levels=levels,
                                    compute_dtype=cdt)
    else:
        forward = functools.partial(plain_forward, cfg=cfg.model, compute_dtype=cdt)
    return prepare, forward
