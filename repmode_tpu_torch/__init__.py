"""repmode_tpu_torch: RepMode subcellular structure prediction in PyTorch on a CUDA card.

The port of ``repmode_tpu`` (JAX on a TPU), beside it in the same repository.
It imports torch and numpy, never jax and nothing of ``repmode_tpu``; each
module mirrors its JAX counterpart's name and place. Every TPU kernel on a
ported path is a hand-written CUDA kernel (sources in ``csrc/``, built on
first use by ``ops/kernels/build.py``) with a plain PyTorch version beside it.

Ported so far: the serving path (``cli.evaluate``): the MoDE net in eval
mode, its once-per-task re-parameterization into a plain conv net, tiled
inference with Gaussian stitching, metrics and the eval CLI; and the
training path (``cli.train``): the train-mode net with the per-sample merged
MoDE conv, batch-stat BN, the train step with Adam, the host patch sampler
(its C++ batcher in ``native/``), ``.p`` checkpoints and the experiment loop;
and the data path and run records: CZI ingest from the reference's CSVs
(``data/czi``, ``data/ingest``, ``data/csv_tools``, without pandas), saved
manifests, the run tracker and the test predictions as TIFFs.
"""

from repmode_tpu_torch.version import __version__

__all__ = ["__version__"]
