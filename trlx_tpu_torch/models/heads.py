"""Value head, the PPO policy wrappers and the ILQL heads (counterpart of
:mod:`trlx_tpu.models.heads`: ``MLPHead``, ``CausalLMWithValueHead``,
``T5WithValueHead``, ``ILQLHeads`` and ``CausalLMWithILQLHeads``), and the
random init of a policy from a seed."""

from __future__ import annotations

import re
from typing import Any, Optional, Tuple

import torch
from torch import nn

from trlx_tpu_torch.models.gpt2 import GPT2Model, Linear, torch_dtype
from trlx_tpu_torch.models.t5 import T5Config, T5Model


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


class T5WithValueHead(nn.Module):
    """T5/UL2 backbone (``t5``) + scalar value head (``v_head``) on the
    decoder's hidden states: the fork's seq2seq policy. ``forward`` is the
    teacher-forced pass; ``encode``, ``init_cross_kv`` and ``decode`` (with
    values) serve the seq2seq sampler."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        self.config = config
        self.t5 = T5Model(config, device=device)
        self.v_head = MLPHead(
            config.d_model, 1, dtype=config.dtype, param_dtype=config.param_dtype,
            device=device,
        )

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        out = self.t5(
            input_ids,
            attention_mask=attention_mask,
            decoder_input_ids=decoder_input_ids,
            decoder_attention_mask=decoder_attention_mask,
        )
        out["values"] = self.v_head(out["hidden"])[..., 0]
        return out

    def encode(self, input_ids, attention_mask=None):
        return self.t5.encode(input_ids, attention_mask)

    def init_cross_kv(self, encoder_hidden):
        return self.t5.init_cross_kv(encoder_hidden)

    def decoder_rel_bias(self, capacity: int):
        return self.t5.decoder_rel_bias(capacity)

    def decode(self, decoder_input_ids, encoder_mask=None, decoder_mask=None,
               cache=None, cache_index=None, cross_kv=None, rel_bias=None):
        out = self.t5.decode(
            decoder_input_ids,
            encoder_mask=encoder_mask,
            decoder_mask=decoder_mask,
            cache=cache,
            cache_index=cache_index,
            cross_kv=cross_kv,
            rel_bias=rel_bias,
        )
        out["values"] = self.v_head(out["hidden"])[..., 0]
        return out


class ILQLHeads(nn.Module):
    """ILQL's heads over a hidden state: Q heads (``q1_head``, and
    ``q2_head`` with ``two_qs``) mapping to vocab-size action values and
    the scalar ``v_head``; ``with_v=False`` builds the Q heads alone (the
    target heads). The names are the flax tree's, so
    :func:`~trlx_tpu_torch.models.convert.flax_to_torch` carries the JAX
    package's ``heads`` and ``target_q_params`` trees across unchanged."""

    def __init__(self, config: Any, two_qs: bool = True, with_v: bool = True, device=None):
        super().__init__()
        from trlx_tpu_torch.models.registry import hidden_size_of

        n = hidden_size_of(config)
        kw = {"dtype": config.dtype, "param_dtype": config.param_dtype, "device": device}
        self.n_qs = 2 if two_qs else 1
        for i in range(self.n_qs):
            setattr(self, f"q{i + 1}_head", MLPHead(n, config.vocab_size, **kw))
        self.v_head = MLPHead(n, 1, **kw) if with_v else None

    def q_heads(self) -> Tuple[MLPHead, ...]:
        return tuple(getattr(self, f"q{i + 1}_head") for i in range(self.n_qs))

    def q(self, action_hidden: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(head(action_hidden) for head in self.q_heads())

    def v(self, state_hidden: torch.Tensor) -> torch.Tensor:
        return self.v_head(state_hidden)[..., 0]


class CausalLMWithILQLHeads(nn.Module):
    """Causal LM backbone (``transformer``) + :class:`ILQLHeads`
    (``heads``). One forward returns the logits, the Q values at the
    action states, the values at the states and the action states' hidden
    (``action_hidden``, which the target heads read)."""

    def __init__(self, config: Any, two_qs: bool = True, backbone_cls=GPT2Model, device=None):
        super().__init__()
        self.config = config
        self.transformer = backbone_cls(config, device=device)
        self.heads = ILQLHeads(config, two_qs, device=device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        actions_ixs: Optional[torch.Tensor] = None,
        states_ixs: Optional[torch.Tensor] = None,
        cache=None,
        cache_index=None,
        last_only: bool = False,
    ):
        """``actions_ixs``/``states_ixs`` gather the hidden states the Q and
        V heads read (all positions without them). ``last_only=True``
        computes the logits and heads at the final position only (the
        sampler's prefill) and excludes the gathers."""
        from trlx_tpu_torch.ops.ilql_math import batch_gather

        if last_only and (actions_ixs is not None or states_ixs is not None):
            raise ValueError(
                "last_only keeps the final position only; actions_ixs/"
                "states_ixs gathers cannot be combined with it"
            )
        out = self.transformer(
            input_ids,
            attention_mask=attention_mask,
            position_ids=position_ids,
            cache=cache,
            cache_index=cache_index,
            compute_logits=not last_only,
        )
        hidden = out["hidden"]
        if last_only:
            hidden = hidden[:, -1:]
            out["logits"] = self.transformer.logits(hidden)
        action_hidden = hidden if actions_ixs is None else batch_gather(hidden, actions_ixs)
        state_hidden = hidden if states_ixs is None else batch_gather(hidden, states_ixs)
        out.update(qs=self.heads.q(action_hidden), vs=self.heads.v(state_hidden),
                   action_hidden=action_hidden)
        return out


def init_params(model: nn.Module, seed: int) -> None:
    """Random init from ``seed``: N(0, 0.02) weights, embeddings and
    relative position tables, zero biases (and gpt2_moe's expert biases
    ``bi``, ``bo``), unit layer-norm scales (GPT-2's,
    GPT-J's and GPT-NeoX's ``ln_*``, T5's ``ln_*`` and ``*_ln``). The draws
    are f32 whatever a parameter's dtype, one tensor at a time, so a model
    built in bf16 holds exactly the f32 build's weights rounded to bf16."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", ".bi", ".bo")):
                p.zero_()
            elif re.search(r"[._]ln[._]", name):
                p.fill_(1.0)
            elif p.dtype == torch.float32:
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.copy_(torch.empty(p.shape, device=p.device).normal_(0.0, 0.02, generator=gen))
