"""Config schema (counterpart of :mod:`trlx_tpu.data`)."""
