"""The measurement entry points of the PyTorch/CUDA port (``repmode_tpu_torch``).

``python -m bench_torch.serve`` times full-volume tiled inference, the
counterpart of ``bench.py``; ``python -m bench_torch.train`` times the train
step, the counterpart of ``tools/bench_train.py``. Both print one JSON record
per route on stdout and take ``--profile DIR`` for a separate traced run
(``bench_torch.profile``). They import torch, numpy and the port, never JAX or
the JAX package, and run on the card unless given ``--device cpu``.
"""
