"""Portable deterministic weight synthesis for full-scale parity goldens.

The port's own copy of ``tools/golden_common.py`` (the port imports nothing
of ``tools/``); its values are bit-equal to the original's
(``tests/test_torch_port_parity.py``).

The full RepMode topology (mult_chan=32, 12 tasks) has ~125M parameters, so
golden files cannot vendor the weights. Instead every side — the PyTorch
reference run that wrote the goldens, the JAX checker and the port's checker
(``tools_torch/parity_check.py``) — synthesizes identical weights from a parameter SPEC
(ordered list of (torch_state_dict_name, shape, kind)) using numpy's Philox
generator, which is stable across platforms and numpy versions
(np.random.default_rng with a SeedSequence of ints).

kinds:
  param  learnable tensor -> scaled standard normal (keyed by name)
  zeros  BN running_mean at init
  ones   BN running_var at init
  skip   fixed buffers (avg-pool kernels, num_batches_tracked) — architectural
         constants that both frameworks reconstruct internally

Gradient probes: full-scale gradients are also too big to store, so the
golden keeps, per parameter, ||g|| and the projections g . p_j onto 3
deterministic random probe vectors (same Philox scheme). A projection
difference |d1 - d2| <= ||g1 - g2|| * ||p||, so tight bounds on the probe
dots + the norm pin the gradient to the reference's in random directions.
"""

from __future__ import annotations

import zlib

import numpy as np

SEED = 7
N_PROBES = 3
# leaves with at most this many elements store their full gradient tensor
SMALL_LEAF_MAX = 65536


def _rng(stream: int, name: str) -> np.random.Generator:
    return np.random.default_rng([SEED, stream, zlib.crc32(name.encode())])


def synth_value(name: str, shape, kind: str, dtype=np.float64) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    if kind == "zeros":
        return np.zeros(shape, dtype)
    if kind == "ones":
        return np.ones(shape, dtype)
    assert kind == "param", kind
    rng = _rng(0, name)
    if len(shape) >= 2:  # conv kernels (Co,Ci,k,k,k), gate Linear (Out,In)
        fan_in = int(np.prod(shape[1:]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(dtype)
    if name.endswith(".weight"):  # 1-dim .weight == BatchNorm scale
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(dtype)
    return (0.1 * rng.standard_normal(shape)).astype(dtype)  # biases


def synth_state_dict(spec, dtype=np.float64) -> dict:
    """spec: list of [name, shape, kind] -> {name: ndarray} (skips 'skip')."""
    out = {}
    for name, shape, kind in spec:
        if kind == "skip":
            continue
        out[name] = synth_value(name, shape, kind, dtype)
    return out


def probe(name: str, shape, j: int) -> np.ndarray:
    """j-th deterministic probe vector for a parameter (float64)."""
    return _rng(1 + j, name).standard_normal(tuple(int(s) for s in shape))
