#!/usr/bin/env python3
"""Convert an Orbax checkpoint of the JAX package into a reference ``.p``.

    python convert_orbax_checkpoint.py <orbax checkpoint dir> <out.p>

The PyTorch port (``repmode_tpu_torch``) reads no Orbax directory, because
that needs JAX. This script runs where JAX and Orbax are installed (a TPU
host, or any machine with the JAX package's requirements), and is the one
file of the repo that imports both packages. It restores the JAX train state
with the config saved beside it (``repmode_tpu.ckpt``), and writes what the
port's ``ckpt.save_checkpoint`` writes: ``nn_module``, ``opts`` (the task
list and the config as JSON), ``nn_state`` (the weights and BN statistics in
the port's names and layouts), ``optimizer_state`` and the counters
(``count_iter`` = the JAX step, ``count_epoch`` = the JAX epoch).

Both models (RepMode, UNet) and both Adam layouts of the JAX package carry
over: under the ``flat`` schema the moments are one vector each in
``ravel_pytree(params)`` order and are unravelled with the params' unravel
function; under ``per_tensor`` they are optax trees. Each moment leaf goes
through its parameter's layout map and becomes ``torch.optim.Adam`` state
(``exp_avg``, ``exp_avg_sq``, ``step`` = the Adam count) of that parameter,
so a port run resumes with the same Adam. If a moment leaf has no parameter
to map to, the script names it and writes no Adam state: a resume then
restarts Adam.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch


def adam_state(net: torch.nn.Module, mu_sd: Dict[str, torch.Tensor],
               nu_sd: Dict[str, torch.Tensor], count: int) -> Tuple[Dict, List[str]]:
    """torch Adam state {param: {'step', 'exp_avg', 'exp_avg_sq'}} of ``net``
    from the moments in the port's names, and the moment leaves that map to
    no parameter of ``net`` (or to one of another shape), with the
    parameters that got no moment."""
    params = dict(net.named_parameters())
    unmapped = sorted(
        [k for k in mu_sd.keys() | nu_sd.keys()
         if k not in params or k not in mu_sd or k not in nu_sd
         or tuple(mu_sd[k].shape) != tuple(params[k].shape)
         or tuple(nu_sd[k].shape) != tuple(params[k].shape)]
        + [f"{k} (no moment)" for k in params if k not in mu_sd and k not in nu_sd])
    if unmapped:
        return {}, unmapped
    state = {p: {"step": torch.tensor(float(count), dtype=torch.float32),
                 "exp_avg": mu_sd[k].to(p.dtype).clone(),
                 "exp_avg_sq": nu_sd[k].to(p.dtype).clone()}
             for k, p in params.items()}
    return state, []


def jax_adam_moments(jstate):
    """(mu tree, nu tree, count) of the JAX state's Adam, in the params' tree
    layout, or None for an optimizer of another kind."""
    import jax
    from jax.flatten_util import ravel_pytree

    from repmode_tpu.ckpt.checkpoint import _schema_of_opt_state

    opt = jstate.opt_state
    schema = _schema_of_opt_state(opt)
    if schema == "flat":
        _, unravel = ravel_pytree(jstate.params)
        mu, nu, count = unravel(opt.mu), unravel(opt.nu), opt.count
    elif schema == "per_tensor":
        mu, nu, count = opt[0].mu, opt[0].nu, opt[0].count
    else:
        return None
    mu, nu = jax.tree.map(np.asarray, (mu, nu))
    return mu, nu, int(count)


def convert(src: str, dst: str, log=print) -> List[str]:
    """Write the ``.p`` of the Orbax checkpoint ``src`` to ``dst``. Returns
    the moment leaves that could not be mapped (empty when Adam carried over)."""
    import jax

    from repmode_tpu.ckpt import restore_train_state
    from repmode_tpu.ckpt.checkpoint import load_config
    from repmode_tpu_torch.ckpt.checkpoint import save_checkpoint
    from repmode_tpu_torch.compat.weights import from_jax_variables
    from repmode_tpu_torch.config import Config
    from repmode_tpu_torch.train.state import create_train_state

    jcfg = load_config(src)
    jstate, jcfg = restore_train_state(src, jcfg)
    cfg = Config.from_json(jcfg.to_json())
    state = create_train_state(cfg, device="cpu")
    state.net.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jstate.variables)),
                              strict=True)

    moments = jax_adam_moments(jstate)
    if moments is None:
        unmapped = [f"opt_state ({type(jstate.opt_state).__name__}, not Adam)"]
    else:
        mu, nu, count = moments
        try:
            opt_state, unmapped = adam_state(state.net, from_jax_variables(mu),
                                             from_jax_variables(nu), count)
        except KeyError as e:  # a top-level entry no layout map knows
            opt_state, unmapped = {}, [e.args[0]]
        state.optimizer.state.update(opt_state)
    if unmapped:
        log("convert_orbax_checkpoint: Adam moments that map to no parameter: "
            + ", ".join(unmapped) + "; the .p carries no Adam state, so a resume restarts Adam")
    state.step, state.epoch = int(jstate.step), int(jstate.epoch)
    save_checkpoint(dst, state, cfg)
    log(f"convert_orbax_checkpoint: {cfg.model.name} at step {state.step}, epoch "
        f"{state.epoch} -> {dst}")
    return unmapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="an Orbax checkpoint directory written by repmode_tpu")
    ap.add_argument("dst", help="the .p file to write")
    ns = ap.parse_args(argv)
    convert(ns.src, ns.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
