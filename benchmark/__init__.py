"""The benchmark of repmode_tpu_torch: ``python3 -m benchmark.run`` (see ``run.py``)."""
