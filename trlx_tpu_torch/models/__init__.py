"""Model families (counterpart of :mod:`trlx_tpu.models`; GPT-2 in this
slice)."""
