"""Continuous-batching inference (counterpart of :mod:`trlx_tpu.inference`).

- :mod:`trlx_tpu_torch.inference.kv_cache` — the paged/block KV cache;
- :mod:`trlx_tpu_torch.inference.engine` — the slot-admission decode loop;
- :mod:`trlx_tpu_torch.inference.server` — submit/poll serving over it.

Config surface: ``train.rollout`` (:class:`RolloutEngineConfig`), parsed
and validated exactly as the JAX package parses it, chunked prefill and
speculative decoding included.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

ROLLOUT_ENGINES = ("fixed", "continuous")
SPEC_DRAFTERS = ("trie", "ngram")


@dataclass(frozen=True)
class SpecDecodeConfig:
    """Parsed ``train.rollout.spec_decode`` section (same keys and
    validation as the JAX package).

    :param enabled: turn drafted verify steps on.
    :param max_draft: draft-token cap per slot per verify step.
    :param drafter: ``"trie"`` or ``"ngram"``.
    :param min_accept_ewma: per-tenant accept-rate floor in [0, 1].
    """

    enabled: bool = False
    max_draft: int = 4
    drafter: str = "trie"
    min_accept_ewma: float = 0.0

    def __post_init__(self):
        if self.max_draft < 1:
            raise ValueError(
                f"train.rollout spec_decode.max_draft={self.max_draft} "
                "must be >= 1"
            )
        if self.drafter not in SPEC_DRAFTERS:
            raise ValueError(
                f"train.rollout spec_decode.drafter={self.drafter!r} is "
                f"not supported (choose one of {SPEC_DRAFTERS})"
            )
        if not 0.0 <= self.min_accept_ewma <= 1.0:
            raise ValueError(
                "train.rollout spec_decode.min_accept_ewma="
                f"{self.min_accept_ewma} must be in [0, 1]"
            )

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "SpecDecodeConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"Unknown train.rollout spec_decode keys: "
                f"{sorted(unknown)} (known: {sorted(known)})"
            )
        if "enabled" in d and d["enabled"] is not None:
            d["enabled"] = bool(d["enabled"])
        if "max_draft" in d and d["max_draft"] is not None:
            d["max_draft"] = int(d["max_draft"])
        if "min_accept_ewma" in d and d["min_accept_ewma"] is not None:
            d["min_accept_ewma"] = float(d["min_accept_ewma"])
        return cls(**d)


@dataclass(frozen=True)
class RolloutEngineConfig:
    """Parsed ``train.rollout`` section (same keys and validation as
    :class:`trlx_tpu.inference.RolloutEngineConfig`).

    :param engine: ``"fixed"`` or ``"continuous"`` (the server always
        serves through the continuous engine).
    :param slots: decode-slot pool size B; 0 = the method's ``chunk_size``
        (else ``train.batch_size``).
    :param admit_width: rows per admission prefill; 0 = ``slots // 4``.
    :param harvest_width: completed rows per harvest group; 0 =
        ``admit_width``. Must be <= slots.
    :param block_size: paged-KV block size; shrunk to the largest divisor
        of the cache capacity (Q + max_new_tokens).
    :param poll_interval: fetch the engine's [B] ``done`` flags every k-th
        decode step (the flags are sticky, so the amortized poll is exact).
    :param per_row_rng: per-row sampling noise in the FIXED sampler too
        (``None`` = only under ``engine: continuous``, which always samples
        per row): the two engines then draw one row's noise alike.
    :param prefill_chunk: chunked admission prefill width in prompt
        columns (rounded by
        :func:`~trlx_tpu_torch.inference.kv_cache.choose_prefill_chunk`);
        0 = the monolithic prefill.
    :param prefill_chunks_per_pump: serving-pump chunk budget (needs
        ``prefill_chunk``); 0 = unbounded.
    :param spec_decode: :class:`SpecDecodeConfig` (continuous engine
        only).
    """

    engine: str = "fixed"
    slots: int = 0
    admit_width: int = 0
    harvest_width: int = 0
    block_size: int = 16
    poll_interval: int = 1
    per_row_rng: Optional[bool] = None
    prefill_chunk: int = 0
    prefill_chunks_per_pump: int = 0
    spec_decode: Optional[SpecDecodeConfig] = None

    def __post_init__(self):
        if (
            self.spec_decode is not None
            and self.spec_decode.enabled
            and self.engine != "continuous"
        ):
            raise ValueError(
                "train.rollout spec_decode.enabled needs the continuous "
                f"engine (got engine={self.engine!r}) — the fixed "
                "sampler has no verify step"
            )
        if self.engine not in ROLLOUT_ENGINES:
            raise ValueError(
                f"train.rollout engine={self.engine!r} is not supported "
                f"(choose one of {ROLLOUT_ENGINES})"
            )
        if self.block_size < 1:
            raise ValueError(
                f"train.rollout block_size={self.block_size} must be >= 1"
            )
        if self.poll_interval < 1:
            raise ValueError(
                f"train.rollout poll_interval={self.poll_interval} must "
                "be >= 1"
            )
        if self.prefill_chunk < 0:
            raise ValueError(
                f"train.rollout prefill_chunk={self.prefill_chunk} must "
                "be >= 0 (0 = monolithic prefill)"
            )
        if self.prefill_chunks_per_pump < 0:
            raise ValueError(
                "train.rollout prefill_chunks_per_pump="
                f"{self.prefill_chunks_per_pump} must be >= 0 "
                "(0 = unbounded)"
            )
        if self.prefill_chunks_per_pump and not self.prefill_chunk:
            raise ValueError(
                "train.rollout prefill_chunks_per_pump needs chunked "
                "prefill (prefill_chunk > 0) — the monolithic program "
                "has nothing to budget"
            )

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "RolloutEngineConfig":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"Unknown train.rollout keys: {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        for name in (
            "slots", "admit_width", "harvest_width", "block_size",
            "poll_interval", "prefill_chunk", "prefill_chunks_per_pump",
        ):
            if name in d and d[name] is not None:
                d[name] = int(d[name])
        if "spec_decode" in d and isinstance(d["spec_decode"], dict):
            d["spec_decode"] = SpecDecodeConfig.from_dict(d["spec_decode"])
        return cls(**d)

    def check_model(self, model_config: Any) -> None:
        """Refuse what this section asks of a model that cannot do it,
        before any engine is built: speculative decoding on a GPT-Neo with
        local (sliding-window) layers. Its band cannot take the verify
        step's [B, Q] cache index, in the JAX package either (ROADMAP
        queue 3)."""
        spec_on = self.spec_decode is not None and self.spec_decode.enabled
        if spec_on and "local" in getattr(model_config, "layer_types", ()):
            raise NotImplementedError(
                "train.rollout spec_decode on a GPT-Neo with local attention "
                "layers: the local band cannot take the verify step's [B, Q] "
                "cache_index, in the JAX package either (ROADMAP queue 3)"
            )

    @property
    def rows_per_row_rng(self) -> bool:
        """Whether the fixed sampler samples per row under this config."""
        if self.per_row_rng is not None:
            return bool(self.per_row_rng)
        return self.engine == "continuous"


__all__ = [
    "ROLLOUT_ENGINES",
    "SPEC_DRAFTERS",
    "RolloutEngineConfig",
    "SpecDecodeConfig",
]
