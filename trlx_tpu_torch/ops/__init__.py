"""Attention, the flash-attention kernel and sampling (counterpart of
:mod:`trlx_tpu.ops`)."""
