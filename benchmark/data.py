"""Everything a run feeds, made from its seed on the device.

- ``weights``: the net's whole state (``reference.nets.spec``: names,
  shapes, laws) from one generator on the device in one draw, each leaf a
  view of it: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as the published init
  draws it, BN at its initial state, the fixed pool kernels.
- ``volumes``: the configuration's distinct volumes (signal, and target
  where the mix trains), N(0, 1) float32 from the same generator after the
  weights, copied to the host once, where the program's stores keep them.
- a served net (a mix of kind ``serve``) has BN statistics that follow
  its activations, as a trained net's do: those of the reference's
  train-mode forward on the central patch of each volume, one a task
  (``reference.record_bn_statistics``), written over the initial 0 and 1.

The same seed gives the same weights whichever side asks, so the reference
draws them again after the window instead of keeping a copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import nets


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def weights(cfg: dict, gen: torch.Generator, device: torch.device) -> Dict[str, torch.Tensor]:
    entries = nets.spec(cfg)
    uniform = [e for e in entries if e.law == "uniform"]
    sizes = [int(np.prod(e.shape)) for e in uniform]
    bounds = torch.tensor([e.value ** -0.5 for e in uniform], dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    flat.mul_(2.0).sub_(1.0).mul_(torch.repeat_interleave(bounds, counts))
    state: Dict[str, torch.Tensor] = {}
    for e, part in zip(uniform, torch.split(flat, sizes)):
        state[e.name] = part.view(e.shape)
    for e in entries:
        if e.law == "zeros":
            state[e.name] = torch.zeros(e.shape, device=device)
        elif e.law == "ones":
            state[e.name] = torch.ones(e.shape, device=device)
        elif e.law == "fill":
            state[e.name] = torch.full(e.shape, e.value, device=device)
        elif e.law == "count":
            state[e.name] = torch.zeros(e.shape, dtype=torch.long, device=device)
    return {e.name: state[e.name] for e in entries}


def volumes(n: int, shape: Tuple[int, int, int], with_target: bool, gen: torch.Generator,
            device: torch.device) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(signals, targets) as host float32 arrays; targets empty without ``with_target``."""
    kinds = 2 if with_target else 1
    vols = torch.randn((kinds, n, *shape), generator=gen, device=device).cpu().numpy()
    signals = [vols[0, i] for i in range(n)]
    targets = [vols[1, i] for i in range(n)] if with_target else []
    return signals, targets


def record_bn(cfg: dict, mix: dict, state: Dict[str, torch.Tensor], signals: List[np.ndarray],
              device: torch.device) -> None:
    if mix.get("kind") != "serve":
        return
    from benchmark import reference

    p = mix["patch_size"]
    patches = []
    for v in signals:
        lo = [(s - q) // 2 for s, q in zip(v.shape, p)]
        patches.append(torch.from_numpy(np.ascontiguousarray(
            v[lo[0]:lo[0] + p[0], lo[1]:lo[1] + p[1], lo[2]:lo[2] + p[2]])))
    x = torch.stack(patches)[:, None].to(device)
    task = torch.arange(len(signals), device=device) % cfg["num_tasks"]
    reference.record_bn_statistics(state, x, task, cfg)


def seeded(cfg: dict, mix: dict, seed: int, device: torch.device):
    """(weights, signals, targets) of one run."""
    gen = generator(seed, device)
    state = weights(cfg, gen, device)
    signals, targets = volumes(cfg["distinct_volumes"], tuple(mix["volume_shape"]),
                               mix["kind"] == "train", gen, device)
    record_bn(cfg, mix, state, signals, device)
    return state, signals, targets


def seeded_weights(cfg: dict, mix: dict, seed: int, device: torch.device,
                   signals: List[np.ndarray]) -> Dict[str, torch.Tensor]:
    """The run's weights again (the first draw of its generator, and the BN
    statistics recorded on its volumes where the mix records them)."""
    state = weights(cfg, generator(seed, device), device)
    record_bn(cfg, mix, state, signals, device)
    return state
