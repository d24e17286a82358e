"""The benchmark of rtweekend_tpu_torch on the card: `benchmark/run.py`."""
