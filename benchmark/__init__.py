"""The benchmark of ``lifelong_nnunet_tpu_torch`` (see ``run.py``)."""
