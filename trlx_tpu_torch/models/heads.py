"""Value head and the PPO policy wrapper (counterpart of
:mod:`trlx_tpu.models.heads`: ``MLPHead`` and ``CausalLMWithValueHead``),
and the random init of a policy from a seed."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from trlx_tpu_torch.models.gpt2 import GPT2Model, Linear, torch_dtype


class MLPHead(nn.Module):
    """Dense(2n) -> ReLU -> Dense(out); the last layer computes in f32."""

    def __init__(self, hidden_size: int, output_size: int = 1,
                 dtype="bfloat16", param_dtype="float32", device=None):
        super().__init__()
        fk = {"device": device, "dtype": torch_dtype(param_dtype)}
        self.fc1 = Linear(hidden_size, 2 * hidden_size, torch_dtype(dtype), **fk)
        self.fc2 = Linear(2 * hidden_size, output_size, torch.float32, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


class CausalLMWithValueHead(nn.Module):
    """Causal LM backbone (``transformer``) + scalar value head
    (``v_head``); one forward returns logits and values (f32)."""

    def __init__(self, config: Any, backbone_cls=GPT2Model, device=None):
        super().__init__()
        from trlx_tpu_torch.models.registry import hidden_size_of

        self.config = config
        self.transformer = backbone_cls(config, device=device)
        self.v_head = MLPHead(
            hidden_size_of(config), 1, dtype=config.dtype,
            param_dtype=config.param_dtype, device=device,
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        cache=None,
        cache_index=None,
        last_only: bool = False,
        skip_heads: bool = False,
    ):
        """``last_only=True`` computes logits/values for the final position
        only (prefill); ``skip_heads=True`` computes neither (``logits`` and
        ``values`` are then ``None``)."""
        out = self.transformer(
            input_ids,
            attention_mask=attention_mask,
            position_ids=position_ids,
            cache=cache,
            cache_index=cache_index,
            compute_logits=not (last_only or skip_heads),
        )
        if skip_heads:
            out["values"] = None
        elif last_only:
            h = out["hidden"][:, -1:]
            out["logits"] = self.transformer.logits(h)
            out["values"] = self.v_head(h)[..., 0]
        else:
            out["values"] = self.v_head(out["hidden"])[..., 0]
        return out

    def response_hidden(
        self,
        input_ids: torch.Tensor,  # [B, Q + R]
        attention_mask: torch.Tensor,  # [B, Q + R]
        query_length: int,
    ):
        """(hidden, values) over the response-predicting positions
        Q-1..Q+R-2 only: the hidden states are sliced before the value
        head runs."""
        out = self.transformer(
            input_ids, attention_mask=attention_mask, compute_logits=False
        )
        h = out["hidden"][:, query_length - 1 : -1]
        return h, self.v_head(h)[..., 0]

    def response_forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        query_length: int,
    ):
        """(logits f32, values) over the response-predicting positions:
        the LM head never runs (or backpropagates) over query positions."""
        h, values = self.response_hidden(input_ids, attention_mask, query_length)
        return self.transformer.logits(h), values

    def lm_only(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        cache=None,
        cache_index=None,
    ):
        """Backbone forward without the value head."""
        return self.transformer(
            input_ids,
            attention_mask=attention_mask,
            position_ids=position_ids,
            cache=cache,
            cache_index=cache_index,
        )


def init_params(model: nn.Module, seed: int) -> None:
    """Random GPT-2-style init from ``seed``: N(0, 0.02) weights and
    embeddings, zero biases, unit layer-norm scales."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
