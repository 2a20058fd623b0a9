"""Seq2seq (T5/UL2) PPO trainer, the fork's own path (counterpart of
:mod:`trlx_tpu.trainer.seq2seq_ppo_trainer`).

The rollout layout is the causal trainer's: the "query" is the encoder
input (left-padded to ``train.seq_length``), the "response" the decoder
output. Logprobs and values line up position for position with the
teacher-forced forward on ``shift_tokens_right(response)`` under the
decoder mask ``[1, response_mask[:-1]]``. The policy is a
:class:`~trlx_tpu_torch.models.heads.T5WithValueHead` (random weights from
the seed, or its backbone loaded from ``model.model_path``), the KL
reference a full frozen copy of its initial ``t5`` backbone. Generation takes the decoder
start token from the arch unless ``gen_kwargs`` sets it. Every attention
runs through K1 (and K2, K3 in the update); the two self-attentions' bias
carries the learned relative position table, whose gradient K2 returns.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from trlx_tpu_torch.data.ppo_types import PPORolloutBatch
from trlx_tpu_torch.models.heads import T5WithValueHead, init_params
from trlx_tpu_torch.models.registry import get_model_family, load_arch
from trlx_tpu_torch.models.t5 import init_t5_cache, shift_tokens_right
from trlx_tpu_torch.ops.ppo_math import policy_entropy
from trlx_tpu_torch.ops.sampling import make_seq2seq_sampler
from trlx_tpu_torch.trainer import register_trainer
from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer
from trlx_tpu_torch.utils import logprobs_from_logits


def refuse_for_seq2seq(config) -> None:
    """Raise on what the reference's seq2seq trainer refuses: layer
    freezing and the hydra reference (``logprob_chunk`` is refused through
    ``_supports_logprob_chunk``, continuous-engine rollouts through
    ``_supports_continuous_engine``, pp with the rest of multi-GPU
    parallelism), and on per-row RNG, which the seq2seq sampler (a batch
    key chain in the reference) does not have."""
    model, train = config.model, config.train
    if model.num_layers_unfrozen > 0:
        raise NotImplementedError(
            "num_layers_unfrozen > 0 is not defined for the seq2seq "
            "(encoder-decoder) family: the reference trains the full T5 and "
            "takes a full frozen copy as the KL reference; set "
            "num_layers_unfrozen to 0 or -1"
        )
    if model.resolved_ref_branch_layers > 0:
        raise NotImplementedError(
            "the hydra KL reference is not defined for the seq2seq family "
            "(the fork uses a full frozen copy); set model.ref_branch_layers: 0"
        )
    if (train.rollout or {}).get("per_row_rng"):
        raise NotImplementedError(
            "train.rollout.per_row_rng: the seq2seq sampler draws each step's "
            "noise from one batch stream; remove the key"
        )


@register_trainer("Seq2SeqPPOTrainer")
@register_trainer("T5PPOTrainer")
class Seq2SeqPPOTrainer(PPOTrainer):
    """PPO on an encoder-decoder policy; the arguments are
    :class:`~trlx_tpu_torch.trainer.ppo_trainer.PPOTrainer`'s."""

    def __init__(self, config, *args, **kwargs):
        refuse_for_seq2seq(config)
        super().__init__(config, *args, **kwargs)

    def _setup_model(self) -> None:
        config = self.config
        self.family = get_model_family("t5")
        self.model_config, backbone = load_arch(self.family, config.model, config.train)
        self.model = T5WithValueHead(self.model_config, device=self.device)
        init_params(self.model, config.train.seed)
        if backbone is not None:
            self.model.t5.load_state_dict(backbone)
        self._setup_reference(self.model.t5, self.model_config.num_decoder_layers)

    def _supports_hydra(self) -> bool:
        # the fork keeps a full frozen copy for T5 (ppo_orchestrator.py:41-43)
        return False

    def _supports_logprob_chunk(self) -> bool:
        # the encoder-decoder forward computes its own logits
        return False

    def _supports_continuous_engine(self) -> bool:
        # the engine drives the causal cache contract
        return False

    def _amend_gen_kwargs(self, gen_kwargs: Dict[str, Any]) -> None:
        gen_kwargs.setdefault(
            "decoder_start_token_id", self.model_config.decoder_start_token_id
        )

    def _check_response_budget(self) -> None:
        # max_length counts decoder tokens including the start token,
        # whatever the encoder's length: >= 2 leaves every rollout a token
        if 0 < self.gen_config.max_length < 2:
            raise ValueError(
                f"gen_kwargs max_length={self.gen_config.max_length} counts "
                "decoder tokens including the start token; it must be >= 2 "
                "so that every rollout has a response token"
            )

    def bind_prompt_budget(self, pipeline, role: str = "train") -> None:
        """Encoder prompts do not consume the decoder's budget: nothing to
        check or shrink."""

    def _make_sampler(self):
        return make_seq2seq_sampler(
            _Counted(self),
            functools.partial(init_t5_cache, self.model_config, device=self.device),
            self.gen_config,
        )

    def _decoder_inputs(self, response_tokens, response_mask):
        """Teacher-forced decoder ids (the response shifted right behind the
        start token) and mask (the start, then the response mask but the
        last)."""
        dec_ids = shift_tokens_right(
            response_tokens.long(), self.gen_config.pad_token_id,
            self.gen_config.decoder_start_token_id,
        )
        dec_mask = torch.cat(
            [torch.ones_like(response_mask[:, :1]), response_mask[:, :-1]], 1
        )
        return dec_ids, dec_mask

    @torch.no_grad()
    def score_ref(self, q_ids, q_mask, r_ids, r_mask) -> torch.Tensor:
        """[B, R] logprobs of the responses under the frozen full copy."""
        self.forwards += 1
        dec_ids, dec_mask = self._decoder_inputs(r_ids, r_mask)
        out = self.ref(
            q_ids, attention_mask=q_mask, decoder_input_ids=dec_ids,
            decoder_attention_mask=dec_mask,
        )
        return logprobs_from_logits(out["logits"], r_ids)

    def _forward_logprobs_values(self, mb: PPORolloutBatch):
        self.forwards += 1
        dec_ids, dec_mask = self._decoder_inputs(mb.response_tokens, mb.response_mask)
        out = self.model(
            mb.query_tokens, attention_mask=mb.query_mask,
            decoder_input_ids=dec_ids, decoder_attention_mask=dec_mask,
        )
        logprobs = logprobs_from_logits(out["logits"], mb.response_tokens)
        entropy = policy_entropy(out["logits"]) if self.config.method.ent_coef else None
        return logprobs, out["values"].float(), entropy


class _Counted:
    """The policy's sampler interface, each encoder pass and decoder call
    counted in the trainer's ``forwards``."""

    def __init__(self, trainer: Seq2SeqPPOTrainer):
        self.trainer = trainer
        self.model = trainer.model

    def encode(self, *args, **kwargs):
        self.trainer.forwards += 1
        return self.model.encode(*args, **kwargs)

    def decode(self, *args, **kwargs):
        self.trainer.forwards += 1
        return self.model.decode(*args, **kwargs)

    def init_cross_kv(self, encoder_hidden):
        return self.model.init_cross_kv(encoder_hidden)

    def decoder_rel_bias(self, capacity: int):
        return self.model.decoder_rel_bias(capacity)
