"""The benchmark harness of ``fast_limo_tpu_torch`` (see ``run.py``)."""
