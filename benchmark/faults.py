"""Faults planted in the program under the timed path, for the check's own
tests (``benchmark/tests``) and for reading each fault's numbers on the card
(``calibrate.py``). ``benchmark.run`` never plants one.

Each is a context manager that patches the program while it is open:

- ``unchanged_state`` (training): Adam's step does nothing, so the step
  returns its state unchanged;
- ``half_batch`` (training): the step sees the first half of its batch, the
  loss a mean over that half; (serving) the forward predicts the first half
  of each patch batch and returns zeros for the rest;
- ``expert_leaf_double``, ``expert_leaf_zero`` (training, where the model's
  reference file names a ``FAULT_LEAF``: for RepMode a 5^3 expert the
  per-sample weight-gradient kernel K4 computes): that leaf's gradient comes
  out doubled or zeroed, every other leaf sound: a fault confined to a few
  leaves;
- ``altered_answer`` (serving): one patch of every volume's fourth batch
  comes back as zeros from the forward that produced it.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.reference import nets

@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def unchanged_state():
    from repmode_tpu_torch.train import state as state_mod

    class Frozen(torch.optim.Adam):
        @torch.no_grad()
        def step(self, closure=None):
            return None

    def make(cfg, net):
        return Frozen(net.parameters(), lr=cfg.train.lr, betas=(0.9, 0.999), eps=1e-8)

    with _patched(state_mod, "make_optimizer", make):
        yield


@contextlib.contextmanager
def expert_leaf_grad(leaf: str, scale: float):
    from repmode_tpu_torch.train import state as state_mod

    real = state_mod.create_train_state

    def create(*args, **kwargs):
        st = real(*args, **kwargs)
        dict(st.net.named_parameters())[leaf].register_hook(lambda g: g * scale)
        return st

    with _patched(state_mod, "create_train_state", create):
        yield


@contextlib.contextmanager
def half_batch_train():
    from repmode_tpu_torch.train import step as step_mod

    real = step_mod.make_train_step

    def make(cfg, state, mesh=None):
        step = real(cfg, state, mesh)

        def half(batch):
            n = batch["signal"].shape[0] // 2
            return step({k: v[:n] for k, v in batch.items()})
        return half

    with _patched(step_mod, "make_train_step", make):
        yield


def _wrap_forward(alter):
    from repmode_tpu_torch.infer import predict as predict_mod

    real = predict_mod.TiledPredictor._predict
    count = {"batches": 0}

    def _predict(self, plain_params, vol, st_b):
        out = real(self, plain_params, vol, st_b)
        count["batches"] += 1
        return alter(out, count["batches"])

    return _patched(predict_mod.TiledPredictor, "_predict", _predict)


@contextlib.contextmanager
def half_batch_serve():
    def alter(out, _):
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out

    with _wrap_forward(alter):
        yield


@contextlib.contextmanager
def altered_answer(batches_a_volume: int):
    def alter(out, k):
        if k % batches_a_volume == 4 % batches_a_volume:
            out = out.clone()
            out[0] = 0
        return out

    with _wrap_forward(alter):
        yield


def for_kind(kind: str, batches_a_volume: int, cfg: dict):
    """{fault name: context manager factory} of the faults a cell of this kind
    and configuration can have."""
    if kind == "train":
        out = {"unchanged_state": unchanged_state, "half_batch": half_batch_train}
        leaf = nets.model(cfg).FAULT_LEAF
        if leaf is not None:
            out["expert_leaf_double"] = lambda: expert_leaf_grad(leaf, 2.0)
            out["expert_leaf_zero"] = lambda: expert_leaf_grad(leaf, 0.0)
        return out
    return {"half_batch": half_batch_serve,
            "altered_answer": lambda: altered_answer(batches_a_volume)}
