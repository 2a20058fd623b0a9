"""YAML -> nested dataclass config system.

The port's own copy of :mod:`trlx_tpu.data.configs`: the same three-section
schema (``model`` / ``train`` / ``method``) and the same method dispatch
through the method registry, so every ``configs/*.yml`` parses in both
packages. The ``model`` and ``train`` dataclasses hold only the fields the
port reads. The section's other keys of the shared schema are carried as
given in the section's ``training`` dict; a key outside the schema
raises.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, fields
from typing import Any, Dict, FrozenSet, Optional, Tuple

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


def merge(base: Dict, update: Dict, updated: set) -> Dict:
    """Recursively merge ``update`` into ``base``, recording touched keys
    (the JAX package's ``merge``: a key ``base`` lacks is not added)."""
    for k, v in base.items():
        if k in update and isinstance(v, dict):
            base[k] = merge(v, update[k], updated)
            updated.add(k)
        elif k in update:
            base[k] = update[k]
            updated.add(k)
    return base


def _section_keys(section) -> FrozenSet[str]:
    """The keys a section takes: its fields and its ``training`` keys."""
    return frozenset(f.name for f in fields(section) if f.name != "training") | getattr(
        section, "TRAINING_KEYS", frozenset())


def _set(section, key: str, value) -> None:
    if key in getattr(section, "TRAINING_KEYS", ()):
        section.training[key] = value
    else:
        setattr(section, key, value)


def _to_dict(section) -> Dict[str, Any]:
    out = asdict(section)
    training = out.pop("training")
    return {**out, **training}


@dataclass
class ModelConfig:
    """Which policy model to serve or train.

    :param model_path: HF checkpoint directory (GPT-2 or T5/UL2; its
        ``config.json`` gives the architecture), or empty for random
        weights of ``model_arch``.
    :param tokenizer_path: HF tokenizer path (host-side only).
    :param model_type: model family registered in
        :mod:`trlx_tpu_torch.models.registry`.
    :param num_layers_unfrozen: train only the top-k transformer blocks
        (plus ln_f and the heads); -1 (or 0) trains everything.
    :param ref_branch_layers: depth of the hydra KL-reference branch;
        ``None`` follows ``num_layers_unfrozen`` when positive, 0 is the
        full-copy reference.
    :param model_arch: architecture overrides (n_layer, n_embd, n_head,
        vocab_size, n_positions, ...).
    :param training: the section's other keys, as given (none today).
    """

    TRAINING_KEYS = frozenset()

    model_path: str = ""
    tokenizer_path: str = ""
    model_type: str = "gpt2"
    num_layers_unfrozen: int = -1
    ref_branch_layers: Optional[int] = None
    model_arch: Dict[str, Any] = field(default_factory=dict)
    training: Dict[str, Any] = field(default_factory=dict)

    @property
    def resolved_ref_branch_layers(self) -> int:
        """Hydra branch depth in effect (0 = full-copy reference)."""
        if self.ref_branch_layers is not None:
            return self.ref_branch_layers
        return max(self.num_layers_unfrozen, 0)

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        return _from_dict(cls, config, cls.TRAINING_KEYS)


@dataclass
class TrainConfig:
    """The ``train`` section. Fields and defaults are the JAX package's.

    :param seq_length: prompt length (the query width).
    :param batch_size: PPO minibatch size (and decode slots when neither
        ``rollout.slots`` nor the method's ``chunk_size`` gives them).
    :param total_steps / epochs: the run ends after ``min(total_steps,
        epochs * updates per phase)`` updates.
    :param lr_init / lr_target: cosine learning-rate schedule endpoints.
    :param opt_betas / opt_eps / weight_decay: AdamW.
    :param grad_clip: global-norm gradient clip.
    :param adam_moment_dtype: Adam moment storage: ``float32``, or
        ``bfloat16`` with stochastic rounding (half the moments' bytes;
        :class:`trlx_tpu_torch.trainer.common.LowPrecisionAdamW`).
    :param checkpoint_interval / eval_interval / log_interval: cadence in
        updates.
    :param pipeline / orchestrator / trainer: registry names.
    :param checkpoint_dir: where ``save`` writes.
    :param detect_anomalies: raise on non-finite loss stats.
    :param seed: run seed (parameter init, prompt shuffles, update plans).
    :param phase_overlap: the streamed phase's epoch-major update schedule
        (run serially in the port); ``False`` takes the minibatch-major
        schedule.
    :param dtype: compute dtype.
    :param param_dtype: dtype the weights are made in.
    :param rollout: engine geometry, parsed into
        :class:`trlx_tpu_torch.inference.RolloutEngineConfig`.
    :param serving: QoS/streaming section, parsed into
        :class:`trlx_tpu_torch.serving.ServingConfig`.
    :param training: the section's other keys, as given. Those the port
        does not have are refused by the trainer when set to anything but
        their default (:data:`trlx_tpu_torch.trainer.UNPORTED_TRAIN_KEYS`).
    """

    TRAINING_KEYS = frozenset({
        "resume_from_checkpoint", "async_checkpoint", "health",
        "flight_dump_phase", "run_dir", "resilience", "project_name",
        "run_name", "mesh", "pp_microbatches", "pp_virtual_stages",
        "pp_remat", "logprob_chunk", "rollout_param_cast", "telemetry",
        "async_rl", "rollout_logging_dir", "profile_dir", "profile_phase",
        "tags",
    })

    total_steps: int = 10000
    seq_length: int = 64
    epochs: int = 100
    batch_size: int = 16
    lr_init: float = 1.0e-4
    lr_target: float = 1.0e-4
    opt_betas: Tuple[float, float] = (0.9, 0.95)
    opt_eps: float = 1.0e-8
    weight_decay: float = 1.0e-6
    grad_clip: float = 1.0
    adam_moment_dtype: str = "float32"
    checkpoint_interval: int = 10000
    eval_interval: int = 100
    log_interval: int = 1
    pipeline: str = "PromptPipeline"
    orchestrator: str = "PPOOrchestrator"
    trainer: str = "PPOTrainer"
    checkpoint_dir: str = "ckpts"
    detect_anomalies: bool = True
    seed: int = 1000
    phase_overlap: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    rollout: Dict[str, Any] = field(default_factory=dict)
    serving: Dict[str, Any] = field(default_factory=dict)
    training: Dict[str, Any] = field(default_factory=dict)

    # the resilience keys, read (and ``resume_from_checkpoint`` set) by
    # their JAX package's attribute names; they live in ``training``

    @property
    def resume_from_checkpoint(self) -> bool:
        return bool(self.training.get("resume_from_checkpoint", False))

    @resume_from_checkpoint.setter
    def resume_from_checkpoint(self, value: bool) -> None:
        self.training["resume_from_checkpoint"] = bool(value)

    @property
    def resilience(self) -> Dict[str, Any]:
        return dict(self.training.get("resilience") or {})

    @property
    def rollout_logging_dir(self) -> Optional[str]:
        return self.training.get("rollout_logging_dir")

    @classmethod
    def from_dict(cls, config: Dict[str, Any]):
        if "opt_betas" in config:
            config = dict(config, opt_betas=tuple(config["opt_betas"]))
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

    def update(self, **kwargs) -> None:
        """Apply flat or nested overrides, as the JAX package's ``update``;
        raise on keys that match nothing.

        Takes nested section dicts (``train={"lr_init": 1e-5}``), dotted keys
        (``**{"train.lr_init": 1e-5}``) and bare keys (``lr_init=1e-5``, the
        first section that has it: model, train, method). A section's
        ``training`` keys count as its own."""
        updates = set()
        sections = {"model": self.model, "train": self.train, "method": self.method}
        for k, v in kwargs.items():
            if k in sections and isinstance(v, dict):
                section = sections[k]
                unknown = set(v) - _section_keys(section)
                if unknown:
                    raise ValueError(f"Unknown config keys in {k!r}: {sorted(unknown)}")
                training = getattr(section, "TRAINING_KEYS", ())
                for key, value in v.items():
                    current = (section.training.get(key) if key in training
                               else getattr(section, key))
                    # a dict the section holds merges (its keys only); the
                    # rest, and a training key not given yet, is replaced
                    if isinstance(current, dict):
                        merge(current, value, updates)
                    else:
                        _set(section, key, value)
                updates.add(k)
            elif "." in k:
                section_name, _, name = k.partition(".")
                section = sections.get(section_name)
                if section is not None and name in _section_keys(section):
                    _set(section, name, v)
                    updates.add(k)
            else:
                for section in sections.values():
                    if k in _section_keys(section):
                        _set(section, k, v)
                        updates.add(k)
                        break
        rest = set(kwargs) - updates
        if rest:
            raise ValueError(f"Unknown config keys: {sorted(rest)}")

    def __str__(self):
        import json

        return "TRLConfig:\n" + json.dumps(self.to_dict(), indent=2)
