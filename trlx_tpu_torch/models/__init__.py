"""Model families (counterpart of :mod:`trlx_tpu.models`: GPT-2, GPT-J,
GPT-NeoX and T5/UL2 so far)."""
