"""The port's streamed phase (``phase_overlap``, the default) against the
JAX package's objects and against its own serial run.

- ``StreamPlan.rows_needed`` / ``ready`` equal the JAX plan's for every
  minibatch and landed count;
- the stream store (``begin_stream``, ``push`` with version tags and
  growth past the planned capacity, ``gather`` and ``row_versions`` while
  rows are still landing, ``full``, ``clear_history``, the refusals, and
  group-expanded rows kept contiguous) equals the JAX buffer on the same
  chunks, row for row;
- one phase through ``begin_streamed_phase`` / the orchestrator /
  ``finish_streamed_phase``, its epoch-1 updates run as rows land, equals
  the same plan run serially (``overlap=False``) ``torch.equal`` in
  parameters, the KL sequence and every stats row: on the fixed sampler,
  on the continuous engine, and for GRPO's group-expanded rows; through
  ``learn()`` too, against ``phase_overlap: false``'s serial plan;
- the behaviour snapshot owns its tensors: with the cast off (f32) the
  phase's rollout model is not the policy, and the epoch-1 updates leave
  it as it was.

The port against the JAX package's streamed and asynchronous phases is in
``tests/test_torch_async_rl.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.ppo_types import PPORolloutBatch as JBatch
from trlx_tpu.pipeline import ppo_buffer as jbuf
from trlx_tpu_torch.data.ppo_types import PPORolloutBatch as TBatch
from trlx_tpu_torch.pipeline import ppo_buffer as tbuf

FIELDS = ("query_tokens", "query_mask", "response_tokens", "response_mask",
          "logprobs", "values", "rewards")


# ------------------------------- the plan ------------------------------- #


@pytest.mark.parametrize("total,bs,epochs", [(24, 8, 1), (20, 8, 2), (32, 8, 3)])
def test_plan_ready_accounting_matches_jax(total, bs, epochs):
    jp = jbuf.make_stream_plan(total, bs, epochs, seed=5)
    tp = tbuf.make_stream_plan(total, bs, epochs, seed=5)
    assert (tp.total, tp.n_minibatches) == (jp.total, jp.n_minibatches)
    for k in range(tp.n_minibatches):
        assert tp.rows_needed(k) == jp.rows_needed(k)
        for landed in range(total + 2):
            assert tp.ready(k, landed) == jp.ready(k, landed), (k, landed)


# ---------------------------- the stream store --------------------------- #


def _arrays(rows, base=0, group=1):
    """One chunk whose every field encodes the global row id (or, with
    ``group`` > 1, the id of its G-row group)."""
    ids = np.arange(base, base + rows) // group
    col = ids[:, None].astype(np.float32)
    return {
        "query_tokens": np.tile(ids[:, None], (1, 2)).astype(np.int32),
        "query_mask": np.ones((rows, 2), np.int32),
        "response_tokens": np.tile(ids[:, None], (1, 3)).astype(np.int32),
        "response_mask": np.ones((rows, 3), np.int32),
        "logprobs": np.tile(col, (1, 3)),
        "values": np.tile(col, (1, 3)) * 0.5,
        "rewards": np.tile(col, (1, 3)) * 2.0,
    }


def _pair():
    return jbuf.PPORolloutBuffer(), tbuf.PPORolloutBuffer()


def _push(pair, arrays, versions=None):
    jb, tb = pair
    jb.push(JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}), versions=versions)
    tb.push(TBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}), versions=versions)


def _assert_same(jbatch, tbatch):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(tbatch, k).numpy(), np.asarray(getattr(jbatch, k)),
                                      err_msg=k)


def test_stream_store_lands_gathers_and_tags_as_jax():
    pair = _pair()
    for buf in pair:
        buf.begin_stream(12)
        assert buf.streaming and len(buf) == 0
    # uneven chunks in landing order, some tagged
    _push(pair, _arrays(4, 0))
    _push(pair, _arrays(2, 4), versions=[1, 1])
    jb, tb = pair
    assert len(tb) == len(jb) == 6
    idx = np.asarray([5, 2, 0])
    _assert_same(jb.gather(idx), tb.gather(idx))
    np.testing.assert_array_equal(tb.row_versions(np.arange(6)), jb.row_versions(np.arange(6)))
    for buf in pair:  # a row that has not landed
        with pytest.raises(ValueError, match="landed"):
            buf.gather(np.asarray([6]))
        with pytest.raises(ValueError, match="landed"):
            buf.row_versions(np.asarray([7]))
        with pytest.raises(ValueError, match="versions"):
            buf.push(TBatch(**{k: torch.from_numpy(v) for k, v in _arrays(2).items()})
                     if buf is tb else
                     JBatch(**{k: jnp.asarray(v) for k, v in _arrays(2).items()}),
                     versions=[1])
    _push(pair, _arrays(6, 6), versions=[2, 2, 3, 3, 4, 4])
    _assert_same(jb.full, tb.full)
    stacked = np.asarray([[0, 5], [11, 6]])  # the residual epochs' [n, B] gather
    _assert_same(jb.gather(stacked), tb.gather(stacked))
    np.testing.assert_array_equal(tb.row_versions(stacked), jb.row_versions(stacked))
    np.testing.assert_array_equal(tb.row_versions(np.arange(12)),
                                  [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4])


def test_stream_store_grows_past_the_plan_as_jax():
    pair = _pair()
    for buf in pair:
        buf.begin_stream(8)
    _push(pair, _arrays(5, 0), versions=[0] * 5)
    _push(pair, _arrays(5, 5), versions=[1] * 5)  # overshoots the planned 8
    _push(pair, _arrays(7, 10), versions=[2] * 7)  # and the first bucket (16)
    jb, tb = pair
    assert len(tb) == len(jb) == 17
    assert tb._capacity == jb._capacity == 32  # power-of-two buckets
    _assert_same(jb.full, tb.full)
    np.testing.assert_array_equal(tb.row_versions(np.arange(17)), jb.row_versions(np.arange(17)))
    np.testing.assert_array_equal(tb.full.query_tokens[:, 0].numpy(), np.arange(17))


def test_stream_store_state_transitions_as_jax():
    jb, tb = pair = _pair()
    _push(pair, _arrays(4))
    for buf in pair:
        with pytest.raises(ValueError, match="non-empty"):
            buf.begin_stream(8)
        buf.clear_history()
        with pytest.raises(ValueError, match="capacity"):
            buf.begin_stream(0)
        buf.begin_stream(8)
    _push(pair, _arrays(8))
    assert tb.full.batch_size == jb.full.batch_size == 8
    for buf in pair:
        buf.clear_history()
        assert not buf.streaming and len(buf) == 0
    # chunk mode after a stream, version tags included
    _push(pair, _arrays(3), versions=[4, 5, 6])
    assert len(tb) == len(jb) == 3 and not tb.streaming
    np.testing.assert_array_equal(tb.row_versions(np.asarray([2, 0])),
                                  jb.row_versions(np.asarray([2, 0])))
    _assert_same(jb.full, tb.full)


def test_group_expanded_rows_stay_contiguous_as_jax():
    G, prompts = 3, 4
    pair = _pair()
    for buf in pair:
        buf.begin_stream(G * prompts)
    _push(pair, _arrays(6, 0, group=G))  # two whole groups a chunk
    _push(pair, _arrays(6, 6, group=G))
    jb, tb = pair
    _assert_same(jb.full, tb.full)
    np.testing.assert_array_equal(tb.full.query_tokens[:, 0].numpy(),
                                  np.repeat(np.arange(prompts), G))


# ------------------------- overlapped equals serial ---------------------- #

ARCH = {"vocab_size": 32, "n_positions": 32, "n_embd": 32, "n_layer": 2, "n_head": 2}
ENGINE = {"engine": "continuous", "slots": 8, "admit_width": 4, "harvest_width": 4}


def phase_config(rollout=None, grpo=False, **train) -> dict:
    """``tests/test_async_rl.py``'s phase shape in f32: 24 rollouts in
    chunks of 8, minibatches of 8, 2 PPO epochs (6 updates), sampled."""
    method = {"name": "PPOConfig", "num_rollouts": 24, "chunk_size": 8, "ppo_epochs": 2,
              "init_kl_coef": 0.02,
              "gen_kwargs": {"max_new_tokens": 6, "min_new_tokens": 1, "do_sample": True,
                             "eos_token_id": 30, "pad_token_id": 31}}
    cfg = {
        "model": {"model_type": "gpt2", "model_arch": dict(ARCH)},
        "train": {"seq_length": 8, "batch_size": 8, "epochs": 1, "total_steps": 6,
                  "eval_interval": 1000, "checkpoint_interval": 100000,
                  "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32", "seed": 3,
                  "rollout": dict(rollout or {"engine": "fixed"}), **train},
        "method": method,
    }
    if grpo:
        cfg["train"]["trainer"] = "GRPOTrainer"
        method.update(name="GRPOConfig", group_size=4, vf_coef=0.0)
    return cfg


def phase_prompts():
    rng = np.random.default_rng(3)
    return [[int(x) for x in rng.integers(1, 30, size=int(rng.integers(2, 7)))]
            for _ in range(64)]


def length_reward(samples, queries, response_gt=None):
    return [float(len(s)) for s in samples]


def build(cfg: dict, tmp_path, reward=length_reward):
    """A port trainer on ``cfg`` (its checkpoints under ``tmp_path``) with
    the phase prompts' pipeline and orchestrator."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

    cfg = dict(cfg, train=dict(cfg["train"], checkpoint_dir=str(tmp_path)))
    config = TRLConfig.from_dict(cfg)
    trainer = get_trainer(config.train.trainer)(config, reward_fn=reward, device="cpu")
    pipeline = get_pipeline("PromptPipeline")(phase_prompts(), trainer.query_length)
    get_orchestrator("PPOOrchestrator")(trainer, pipeline, reward_fn=reward,
                                        chunk_size=config.method.chunk_size)
    return trainer


def run_phase(trainer, overlap=None, seed=11, num_rollouts=None):
    """One streamed phase driven through the phase API."""
    phase = trainer.begin_streamed_phase(seed=seed, num_rollouts=num_rollouts, overlap=overlap)
    trainer.orch.make_experience(num_rollouts or trainer.config.method.num_rollouts, 0)
    n_up, rows, kl_seq = trainer.finish_streamed_phase()
    return {"phase": phase, "n_up": n_up, "rows": rows, "kl_seq": kl_seq,
            "params": {n: p.detach().clone() for n, p in trainer.model.state_dict().items()},
            "stats": dict(trainer._last_overlap_stats)}


def assert_runs_equal(a, b):
    assert a["n_up"] == b["n_up"] and a["kl_seq"] == b["kl_seq"]
    assert set(a["rows"]) == set(b["rows"])
    for key in a["rows"]:
        np.testing.assert_array_equal(a["rows"][key], b["rows"][key], err_msg=key)
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name


CASES = {
    "fixed": {},
    "continuous": {"rollout": ENGINE},
    "grpo_grouped": {"grpo": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_overlapped_phase_equals_its_serial_plan(tmp_path, case):
    runs = {}
    for overlap in (None, False):
        trainer = build(phase_config(**CASES[case]), tmp_path / str(overlap))
        landed_at, collecting = [], [False]
        step, collect = trainer.train_step, trainer.orch.make_experience

        def counted(mb, trainer=trainer, step=step, landed_at=landed_at, collecting=collecting):
            if collecting[0]:
                landed_at.append(len(trainer.buffer))
            return step(mb)

        def collect_flagged(*a, collect=collect, collecting=collecting, **kw):
            collecting[0] = True
            try:
                return collect(*a, **kw)
            finally:
                collecting[0] = False

        trainer.train_step, trainer.orch.make_experience = counted, collect_flagged
        runs[overlap] = run_phase(trainer, overlap=overlap)
        runs[overlap]["landed_at"] = landed_at
    overlapped, serial = runs[None], runs[False]
    assert overlapped["n_up"] == 6
    # each epoch-1 minibatch ran as soon as its 8 rows had landed, while
    # later rows were still being sampled; the serial plan ran none then
    assert overlapped["landed_at"] == [8, 16, 24] and serial["landed_at"] == []
    assert overlapped["stats"]["exp/overlap_streamed_updates"] == 3.0
    assert serial["stats"]["exp/overlap_streamed_updates"] == 0.0
    assert_runs_equal(overlapped, serial)
    assert all(np.isfinite(v).all() for v in overlapped["rows"].values())


def test_learn_streams_its_phases_and_matches_the_serial_plan(tmp_path):
    """``learn()`` with the default ``phase_overlap`` takes the streamed
    phase; the same run with every phase's epoch-1 updates held to its
    end (``overlap=False``) gives the same state bit for bit."""
    cfg = phase_config(epochs=2, total_steps=12)
    finals = {}
    for overlap in (None, False):
        trainer = build(cfg, tmp_path / str(overlap))
        begin, seeds = trainer.begin_streamed_phase, []

        def begin_with(seed=0, num_rollouts=None, begin=begin, seeds=seeds, overlap=overlap):
            seeds.append(seed)
            return begin(seed=seed, num_rollouts=num_rollouts, overlap=overlap)

        trainer.begin_streamed_phase = begin_with
        trainer.learn()
        assert seeds == [3, 4] and trainer.step == 12
        assert trainer._stream is None and trainer._behavior_model is None
        finals[overlap] = trainer
    a, b = finals[None], finals[False]
    assert a.kl_coef == b.kl_coef and a.mean_kl == b.mean_kl
    for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), name
    assert [p["rollout_tokens"] for p in a.phase_times] == [
        p["rollout_tokens"] for p in b.phase_times]


def test_the_behaviour_snapshot_owns_its_tensors(tmp_path):
    """f32 compute leaves the rollout cast off, where the rollout model is
    the policy itself: the phase's snapshot must be a copy, untouched by
    the epoch-1 updates that step the masters in place."""
    trainer = build(phase_config(), tmp_path)
    assert trainer.rollout_cast_dtype is None and trainer.rollout_model() is trainer.model
    before = {n: p.detach().clone() for n, p in trainer.model.state_dict().items()}
    trainer.begin_streamed_phase(seed=11)
    snap = trainer.rollout_model()
    assert snap is not trainer.model
    masters = {id(p) for p in trainer.model.parameters()}
    assert not any(id(p) in masters for p in snap.parameters())
    trainer.orch.make_experience(24, 0)
    assert trainer._stream.next_mb == 3  # every epoch-1 update ran while collecting
    moved = [n for n, p in trainer.model.state_dict().items() if not torch.equal(p, before[n])]
    assert moved
    for name, p in snap.state_dict().items():
        assert torch.equal(p, before[name]), name
    trainer.finish_streamed_phase()
    assert trainer.rollout_model() is trainer.model


def test_an_error_aborts_the_phase_and_the_trainer_runs_again(tmp_path):
    calls = [0]

    def failing(samples, queries, response_gt=None):
        calls[0] += 1
        if calls[0] == 2:
            raise TypeError("reward bug")
        return length_reward(samples, queries)

    trainer = build(phase_config(epochs=2, total_steps=12), tmp_path, reward=failing)
    with pytest.raises(TypeError, match="reward bug"):
        trainer.learn()
    assert trainer._stream is None and trainer._behavior_model is None
    assert len(trainer.buffer) == 0 and not trainer.buffer.streaming
    run_phase(trainer)  # re-enterable
