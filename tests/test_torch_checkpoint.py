"""The port's checkpoint writer (``trlx_tpu_torch/utils/checkpoint.py``)
against the JAX package's Orbax manager (``trlx_tpu/utils/checkpoint.py``).

- An asynchronous save returns before its write lands (the write gated
  on an event), and :func:`wait_for_checkpoints` joins it; a write that
  fails re-raises there, once.
- After the same saves, sync and async, the same steps are on disk in
  both packages: two kept, and a directory left by a longer run loses
  its stale steps (all but the newest before the write, that one after).
- ``load`` prefers the newest ``_saved_at`` over the highest step, and an
  unstamped step sorts by its number.
- PPO ``learn`` with ``async_checkpoint: true`` ends in a state, and
  leaves checkpoints, bit-equal to the synchronous run's.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ppo_phase import config, port_trainer
from trlx_tpu_torch.utils import checkpoint as ckpt


def _state(step: int):
    return {"w": torch.full((3,), float(step)), "step": step, "nested": {"x": [step, None]}}


def _steps(directory) -> list:
    return sorted(int(n) for n in os.listdir(directory) if n.isdigit())


def test_async_save_returns_before_a_gated_writer_finishes(tmp_path, monkeypatch):
    gate, started = threading.Event(), threading.Event()
    write = ckpt._write

    def gated(*args):
        started.set()
        assert gate.wait(30)
        return write(*args)

    monkeypatch.setattr(ckpt, "_write", gated)
    writer = ckpt.CheckpointWriter()
    state = _state(3)
    path = writer.save(str(tmp_path), state, 3, async_save=True)
    assert started.wait(30) and not os.path.exists(path)
    state["w"].fill_(-1.0)  # the snapshot was taken: a later change is not written
    assert writer.last_times["save_s"] >= 0 and "write_s" not in writer.last_times
    gate.set()
    ckpt.wait_for_checkpoints()
    assert os.path.exists(path) and writer.last_times["write_s"] >= 0
    loaded = ckpt.load_checkpoint(str(tmp_path))
    assert torch.equal(loaded["w"], torch.full((3,), 3.0)) and loaded["nested"] == {"x": [3, None]}


def test_wait_for_checkpoints_reraises_a_writer_error(tmp_path, monkeypatch):
    def failing(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", failing)
    writer = ckpt.CheckpointWriter()
    writer.save(str(tmp_path), _state(1), 1, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_checkpoints()
    ckpt.wait_for_checkpoints()  # raised once, then cleared
    # a failed write also surfaces at the writer's next save, before it starts
    writer.save(str(tmp_path), _state(2), 2, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        writer.save(str(tmp_path), _state(3), 3)
    assert _steps(tmp_path) == []


@pytest.mark.parametrize("async_save", [False, True])
def test_steps_on_disk_match_the_jax_manager(tmp_path, async_save):
    from trlx_tpu.utils.checkpoint import save_checkpoint as jsave
    from trlx_tpu.utils.checkpoint import wait_for_checkpoints as jwait

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    writer = ckpt.CheckpointWriter()
    # a longer run, then a new run in the same directory
    for step in (10, 20, 30, 40, 5, 10, 15, 20, 25):
        jsave(jdir, {"w": jnp.full((3,), float(step))}, {"step": step},
              async_save=async_save, step=step)
        jwait()
        writer.save(pdir, _state(step), step, async_save=async_save)
        ckpt.wait_for_checkpoints()
        assert _steps(pdir) == _steps(jdir), step
    assert _steps(pdir) == [20, 25]
    assert int(ckpt.load_checkpoint(pdir)["step"]) == 25


def test_the_stale_timeline_goes_only_after_the_new_step_commits(tmp_path, monkeypatch):
    writer = ckpt.CheckpointWriter()
    for step in (10, 20, 30):
        writer.save(str(tmp_path), _state(step), step)
    assert _steps(tmp_path) == [20, 30]
    seen = []
    write = ckpt._write

    def watched(directory, state, step, stale):
        seen.append(_steps(directory))  # before the new step's commit
        return write(directory, state, step, stale)

    monkeypatch.setattr(ckpt, "_write", watched)
    writer.save(str(tmp_path), _state(5), 5, async_save=True)
    ckpt.wait_for_checkpoints()
    assert seen == [[30]]  # the newest stale step outlived the write
    assert _steps(tmp_path) == [5]


def test_load_prefers_the_newest_timeline(tmp_path):
    d = str(tmp_path)
    ckpt._write(d, _state(30), 30, [])
    ckpt._write(d, _state(10), 10, [])  # written later, a lower step
    assert _steps(d) == [10, 30]
    assert ckpt.latest_step(d) == 10 and ckpt.load_checkpoint(d)["step"] == 10
    # unstamped steps sort by number alone, behind any stamped one
    os.remove(os.path.join(d, "10", ckpt.META_FILE))
    with open(os.path.join(d, "30", ckpt.META_FILE)) as f:
        assert json.load(f)["step"] == 30
    assert ckpt.latest_step(d) == 30
    os.remove(os.path.join(d, "30", ckpt.META_FILE))
    assert ckpt.latest_step(d) == 30


def test_async_learn_ends_bit_equal_to_the_sync_run(tmp_path):
    runs = {}
    for async_save in (False, True):
        cfg = config(tmp_path / str(async_save), train={
            "checkpoint_interval": 2, "async_checkpoint": async_save})
        trainer = port_trainer(cfg)
        trainer.learn()
        directory = cfg["train"]["checkpoint_dir"]
        assert trainer._checkpoints._thread is None  # learn joined its end save
        runs[async_save] = (trainer, directory)
    (sync, sdir), (asyn, adir) = runs[False], runs[True]
    assert _steps(sdir) == _steps(adir) == [2, 4]
    for name, p in sync.model.state_dict().items():
        assert torch.equal(asyn.model.state_dict()[name], p), name
    for step in (2, 4):
        want = torch.load(os.path.join(sdir, str(step), ckpt.STATE_FILE), weights_only=True)
        got = torch.load(os.path.join(adir, str(step), ckpt.STATE_FILE), weights_only=True)
        for name, p in want["model"].items():
            assert torch.equal(got["model"][name], p), (step, name)
        for i, st in want["optimizer"]["adamw"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"]["adamw"]["state"][i][k], v), (step, i, k)
        assert {k: got[k] for k in ("step", "kl_coef", "mean_kl")} == {
            k: want[k] for k in ("step", "kl_coef", "mean_kl")}
        assert torch.equal(got["generator"], want["generator"])
    fresh = port_trainer(config(tmp_path / "fresh"))
    fresh.load(adir)
    assert fresh.step == 4
    np.testing.assert_array_equal(
        fresh.model.state_dict()["v_head.fc2.weight"].numpy(),
        asyn.model.state_dict()["v_head.fc2.weight"].numpy())
