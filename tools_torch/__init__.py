"""The correctness tools of the PyTorch/CUDA port (``repmode_tpu_torch``).

``python -m tools_torch.parity_check`` holds the port's net against the
PyTorch reference's fp64 goldens (``tests/goldens/``), the counterpart of
``tools/parity_check.py``; ``python -m tools_torch.train_parity`` trains arms
of the port from one init on one synthetic corpus and compares their
validation MSE per task against a one-ulp chaos floor, the counterpart of
``tools/train_parity.py``. Both import torch, numpy and the port, never JAX
or the JAX package, and run on the card unless given ``--device cpu``.
"""
