"""Attention, the flash-attention kernels, rotary embeddings and sampling
(counterpart of :mod:`trlx_tpu.ops`)."""
