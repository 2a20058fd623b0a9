"""Model families (counterpart of :mod:`trlx_tpu.models`: GPT-2, GPT-J,
GPT-Neo, GPT-NeoX and T5/UL2 so far; ``gpt2_moe`` is still to port)."""
