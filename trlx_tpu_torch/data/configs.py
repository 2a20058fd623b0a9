"""YAML -> nested dataclass config system.

The port's own copy of :mod:`trlx_tpu.data.configs`: the same three-section
schema (``model`` / ``train`` / ``method``) and the same method dispatch
through the method registry, so every ``configs/*.yml`` parses in both
packages. The ``model`` and ``train`` dataclasses hold only the fields the
port reads. The section's other keys of the shared schema (the training
loop's) are carried as given in the section's ``training`` dict, which no
ported code reads; a key outside the schema raises.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, FrozenSet

import yaml

from trlx_tpu_torch.data.method_configs import MethodConfig, get_method


def _from_dict(cls, config: Dict[str, Any], training_keys: FrozenSet[str]):
    known = {f.name for f in fields(cls)} - {"training"}
    unknown = set(config) - known - training_keys
    if unknown:
        raise ValueError(f"Unknown keys for {cls.__name__}: {sorted(unknown)}")
    return cls(
        **{k: v for k, v in config.items() if k in known},
        training={k: v for k, v in config.items() if k in training_keys},
    )


def _to_dict(section) -> Dict[str, Any]:
    out = asdict(section)
    training = out.pop("training")
    return {**out, **training}


@dataclass
class ModelConfig:
    """Which policy model to serve.

    :param model_path: HF checkpoint directory, or empty for random weights
        of ``model_arch`` (the port raises on a path until checkpoint
        conversion is ported).
    :param tokenizer_path: HF tokenizer path (host-side only).
    :param model_type: model family registered in
        :mod:`trlx_tpu_torch.models.registry`.
    :param model_arch: architecture overrides (n_layer, n_embd, n_head,
        vocab_size, n_positions, ...).
    :param training: the section's training-only keys, as given.
    """

    TRAINING_KEYS = frozenset({"num_layers_unfrozen", "ref_branch_layers"})

    model_path: str = ""
    tokenizer_path: str = ""
    model_type: str = "gpt2"
    model_arch: Dict[str, Any] = field(default_factory=dict)
    training: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return _from_dict(cls, config, cls.TRAINING_KEYS)


@dataclass
class TrainConfig:
    """The ``train`` section.

    :param seq_length: prompt length (the engine's query width).
    :param batch_size: decode slots when neither ``rollout.slots`` nor the
        method's ``chunk_size`` gives them.
    :param dtype: compute dtype.
    :param param_dtype: dtype the weights are made in.
    :param rollout: engine geometry, parsed into
        :class:`trlx_tpu_torch.inference.RolloutEngineConfig`.
    :param serving: QoS/streaming section, parsed into
        :class:`trlx_tpu_torch.serving.ServingConfig`.
    :param training: the section's training-loop keys, as given.
    """

    TRAINING_KEYS = frozenset({
        "total_steps", "epochs", "lr_init", "lr_target", "opt_betas",
        "opt_eps", "weight_decay", "grad_clip", "adam_moment_dtype",
        "checkpoint_interval", "eval_interval", "log_interval", "pipeline",
        "orchestrator", "trainer", "checkpoint_dir", "resume_from_checkpoint",
        "async_checkpoint", "detect_anomalies", "health", "flight_dump_phase",
        "run_dir", "resilience", "project_name", "run_name", "seed", "mesh",
        "pp_microbatches", "pp_virtual_stages", "pp_remat", "logprob_chunk",
        "rollout_param_cast", "telemetry", "async_rl", "phase_overlap",
        "rollout_logging_dir", "profile_dir", "profile_phase", "tags",
    })

    seq_length: int = 64
    batch_size: int = 16
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    rollout: Dict[str, Any] = field(default_factory=dict)
    serving: Dict[str, Any] = field(default_factory=dict)
    training: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return _from_dict(cls, config, cls.TRAINING_KEYS)


@dataclass
class TRLConfig:
    """Top-level config: ``model`` + ``train`` + ``method`` sections."""

    model: ModelConfig
    train: TrainConfig
    method: MethodConfig

    @classmethod
    def load_yaml(cls, yml_fp: str) -> "TRLConfig":
        with open(yml_fp) as f:
            config = yaml.safe_load(f)
        return cls.from_dict(config)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "TRLConfig":
        return cls(
            model=ModelConfig.from_dict(config.get("model", {})),
            train=TrainConfig.from_dict(config.get("train", {})),
            method=get_method(config["method"]["name"]).from_dict(
                dict(config["method"])
            ),
        )

    def to_dict(self) -> Dict[str, Any]:
        """The three sections, each with its ``training`` keys back in
        place, so ``from_dict(to_dict())`` round-trips."""
        return {
            "model": _to_dict(self.model),
            "train": _to_dict(self.train),
            "method": self.method.to_dict(),
        }

    def __str__(self):
        import json

        return "TRLConfig:\n" + json.dumps(self.to_dict(), indent=2)
