"""The port's resilience layer against the JAX package's (CPU).

Held:

- one table of exceptions goes through both ``classify_io_error``s, both
  ``classify_checkpoint_error``s and both supervisors' ``failure_kind``
  with equal answers; the port translates torch's own layout errors
  (``load_state_dict``'s missing and unexpected keys and size mismatch,
  the optimizer's group size) into the ``ValueError`` naming
  ``model.num_layers_unfrozen``, and never an ``OSError``;
- ``RetryPolicy``, ``ChaosSpec`` and ``ResilienceConfig`` refuse the same
  bad dicts with the same messages;
- ``retry_call``'s backoff, taken with a fake sleep, and its retry log
  equal the JAX ones;
- one chaos schedule (with a ``TRLX_CHAOS`` spec) fires the same sites in
  the same order with the same errors and event logs in both controllers;
- the preemption guard turns a real SIGTERM into a request and puts back
  the handlers it replaced;
- both background JSONL writers put the same bytes on disk, in the same
  order, under the same write failures (and degrade alike);
- the supervisors restart, resume, back off and give up alike, and leave
  the signal handlers as they found them;
- checkpoint I/O retries and refuses through the chaos sites, on the
  writer thread under ``async_save``; the server's admission retries a
  transient failure and rolls the prefix pool back after a permanent one;
- preempt/resume canaries on the JAX harness's shape
  (``tests/test_resume.py``: 1 block, 16 wide, 2-step phases), greedy,
  through ``trlx_tpu_torch.train``: PPO preempted by a real SIGTERM at
  phase 1 (step 4 of 6) and ILQL at its first chunk boundary (step 4 of
  8), each resumed under ``async_checkpoint``; the port's parameters,
  Adam moments, KL state (PPO), target heads (ILQL) and generator
  ``torch.equal`` to its uninterrupted run, and within
  ``tests/_torch_ppo_phase.py``'s tolerances of the JAX package's resumed
  run from the same initial parameters;
- GRPO and seq2seq PPO, which inherit PPO's ``learn``, resume bit for
  bit too (port only, sampled);
- a finished run resumes without collecting; a checkpoint of another
  freezing layout refuses with the translated error, 0 retries and 0
  restarts.
"""

import errno
import os
import signal
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_ppo_phase import assert_final_params_match
from trlx_tpu.resilience import chaos as jchaos
from trlx_tpu.resilience import supervisor as jsup
from trlx_tpu.resilience.preemption import PreemptionDrain as JDrain
from trlx_tpu.telemetry.health import HealthAbort as JAbort
from trlx_tpu.utils import async_writer as jwriter
from trlx_tpu.utils import checkpoint as jckpt
from trlx_tpu.utils import retry as jretry
from trlx_tpu_torch.models.convert import flax_to_torch
from trlx_tpu_torch.resilience import chaos as tchaos
from trlx_tpu_torch.resilience import preemption as tpre
from trlx_tpu_torch.resilience import supervisor as tsup
from trlx_tpu_torch.resilience.preemption import PreemptionDrain as TDrain
from trlx_tpu_torch.telemetry.health import HealthAbort as TAbort
from trlx_tpu_torch.utils import async_writer as twriter
from trlx_tpu_torch.utils import checkpoint as tckpt
from trlx_tpu_torch.utils import retry as tretry

JAX = SimpleNamespace(chaos=jchaos, sup=jsup, drain=JDrain, abort=JAbort, writer=jwriter,
                      ckpt=jckpt, retry=jretry)
PORT = SimpleNamespace(chaos=tchaos, sup=tsup, drain=TDrain, abort=TAbort, writer=twriter,
                       ckpt=tckpt, retry=tretry)
PACKAGES = {"jax": JAX, "port": PORT}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No chaos spec, retry log or retry policy leaks between tests."""
    monkeypatch.delenv("TRLX_CHAOS", raising=False)
    for pkg in PACKAGES.values():
        pkg.chaos.clear()
        pkg.retry.reset_retry_log()
    yield
    for pkg in PACKAGES.values():
        pkg.chaos.clear()
        pkg.retry.reset_retry_log()
        pkg.retry.set_default_policy(None)


# ----------------------------- the taxonomy ----------------------------- #

ERRORS = {
    "file_not_found": lambda p: FileNotFoundError(errno.ENOENT, "no such file"),
    "permission": lambda p: PermissionError(errno.EACCES, "denied"),
    "not_a_directory": lambda p: NotADirectoryError(errno.ENOTDIR, "not a directory"),
    "is_a_directory": lambda p: IsADirectoryError(errno.EISDIR, "is a directory"),
    "timeout": lambda p: TimeoutError("timed out"),
    "connection": lambda p: ConnectionResetError("reset"),
    "broken_pipe": lambda p: BrokenPipeError("pipe"),
    "interrupted": lambda p: InterruptedError("interrupted"),
    "eio": lambda p: OSError(errno.EIO, "input/output error"),
    "enospc": lambda p: OSError(errno.ENOSPC, "no space left on device"),
    "oserror_with_mismatch_words": lambda p: OSError(errno.EIO, "structure mismatch on NFS"),
    "value": lambda p: ValueError("bad value"),
    "type": lambda p: TypeError("bad type"),
    "key": lambda p: KeyError("missing"),
    "runtime": lambda p: RuntimeError("diverged"),
    "orbax_mismatch": lambda p: ValueError("tree structures do not match"),
    "torch_missing_keys": lambda p: RuntimeError(
        "Error(s) in loading state_dict for M:\n\tMissing key(s) in state_dict: \"w\"."),
    "torch_unexpected_keys": lambda p: RuntimeError(
        "Error(s) in loading state_dict for M:\n\tUnexpected key(s) in state_dict: \"x\"."),
    "torch_size_mismatch": lambda p: RuntimeError(
        "Error(s) in loading state_dict for M:\n\tsize mismatch for w: copying a param with "
        "shape torch.Size([2]) from checkpoint, the shape in current model is torch.Size([3])."),
    "torch_optimizer_group": lambda p: ValueError(
        "loaded state dict contains a parameter group that doesn't match the size of "
        "optimizer's group"),
    "chaos_io": lambda p: p.chaos.ChaosInjectedIOError(errno.EIO, "injected"),
    "chaos_structure": lambda p: p.chaos.ChaosInjectedStructureError(
        "injected (tree structures do not match)"),
    "preemption": lambda p: p.drain("preempted", step=4),
    "health_abort": lambda p: p.abort("aborted"),
    "keyboard_interrupt": lambda p: KeyboardInterrupt(),
    "system_exit": lambda p: SystemExit(1),
}

#: torch's layout errors, which only the port's checkpoint translates
TORCH_LAYOUT = ("torch_missing_keys", "torch_unexpected_keys", "torch_size_mismatch",
                "torch_optimizer_group")


@pytest.mark.parametrize("name", list(ERRORS))
def test_taxonomy_agrees_with_the_jax_package(name):
    """Both ``classify_io_error``s, ``classify_checkpoint_error``s and
    ``failure_kind``s give the same answer for the same error."""
    answers = {}
    for key, pkg in PACKAGES.items():
        error = ERRORS[name](pkg)
        answers[key] = (pkg.retry.classify_io_error(error),
                        pkg.ckpt.classify_checkpoint_error(error),
                        pkg.sup.failure_kind(error))
    assert answers["port"] == answers["jax"]
    # the translation: a layout disagreement never from an OSError
    error = ERRORS[name](PORT)
    translated = tckpt._structure_mismatch_error("/ckpt", error)
    layout = name in TORCH_LAYOUT or name in ("orbax_mismatch", "chaos_structure")
    assert (translated is not None) == layout
    if layout:
        assert "model.num_layers_unfrozen" in str(translated)
        assert "train.adam_moment_dtype" in str(translated)
    if name in TORCH_LAYOUT:
        with pytest.raises(ValueError, match="num_layers_unfrozen") as info:
            with tckpt.translate_structure_errors("/ckpt"):
                raise error
        assert info.value.__cause__ is error


BAD_DICTS = {
    "retry_unknown_key": ("RetryPolicy", {"max_attempt": 3}),
    "retry_zero_attempts": ("RetryPolicy", {"max_attempts": 0}),
    "chaos_unknown_site": ("ChaosSpec", {"site": "nowhere"}),
    "chaos_unknown_mode": ("ChaosSpec", {"site": "preempt", "mode": "nope"}),
    "chaos_zero_count": ("ChaosSpec", {"site": "writer.write", "count": 0}),
    "chaos_unknown_key": ("ChaosSpec", {"site": "preempt", "phse": 1}),
    "chaos_remaining_not_a_key": ("ChaosSpec", {"site": "preempt", "remaining": 3}),
    "resilience_unknown_key": ("ResilienceConfig", {"enabled": True, "restarts": 2}),
    "resilience_negative_restarts": ("ResilienceConfig", {"max_restarts": -1}),
    "resilience_bad_retry": ("ResilienceConfig", {"retry": {"attempts": 2}}),
}


@pytest.mark.parametrize("name", list(BAD_DICTS))
def test_configs_refuse_the_same_bad_dicts(name):
    cls_name, bad = BAD_DICTS[name]
    messages = {}
    for key, pkg in PACKAGES.items():
        owner = {"RetryPolicy": pkg.retry, "ChaosSpec": pkg.chaos,
                 "ResilienceConfig": pkg.sup}[cls_name]
        with pytest.raises(ValueError) as info:
            getattr(owner, cls_name).from_dict(dict(bad))
        messages[key] = str(info.value)
    assert messages["port"] == messages["jax"]


def test_configs_accept_the_same_good_dicts():
    good = {"enabled": True, "max_restarts": 3, "restart_delay_s": 0.5,
            "resume_on_preemption": False, "preempt_signals": ["SIGTERM"],
            "retry": {"max_attempts": 2, "timeout_s": 1.0},
            "chaos": [{"site": "logger.emit", "mode": "error", "count": 2}]}
    got = tsup.ResilienceConfig.from_dict(good)
    want = jsup.ResilienceConfig.from_dict(good)
    assert vars(got) == vars(want)
    assert vars(tretry.RetryPolicy.from_dict(good["retry"])) == vars(
        jretry.RetryPolicy.from_dict(good["retry"]))


# ------------------------------- retry_call ------------------------------ #

RETRY_CASES = {
    "default_recovers": ({}, 2, OSError),
    "default_exhausts": ({}, 10, OSError),
    "capped_backoff": ({"base_delay_s": 0.5, "multiplier": 3.0, "max_delay_s": 2.0,
                        "max_attempts": 6}, 5, OSError),
    "one_attempt": ({"max_attempts": 1}, 1, OSError),
    "wall_clock_budget": ({"timeout_s": 0.12}, 5, OSError),
    "permanent": ({}, 3, ValueError),
}


@pytest.mark.parametrize("name", list(RETRY_CASES))
def test_retry_call_backs_off_as_the_jax_package(name):
    policy, failures, error_type = RETRY_CASES[name]
    runs = {}
    for key, pkg in PACKAGES.items():
        pkg.retry.reset_retry_log()
        sleeps, calls = [], [0]

        def fn():
            calls[0] += 1
            if calls[0] <= failures:
                raise error_type(errno.EIO, "flaky") if error_type is OSError else \
                    error_type("deterministic")
            return "ok"

        try:
            out = pkg.retry.retry_call(fn, policy=pkg.retry.RetryPolicy.from_dict(policy),
                                       describe="op", sleep=sleeps.append)
        except Exception as e:
            out = type(e).__name__
        runs[key] = (out, calls[0], sleeps, list(pkg.retry.retry_log))
    assert runs["port"] == runs["jax"]


# --------------------------------- chaos --------------------------------- #

SPECS = [
    {"site": "checkpoint.save", "mode": "error", "count": 2},
    {"site": "writer.write", "mode": "disk_full", "phase": 1},
    {"site": "engine.admit", "mode": "permanent", "step": 3},
    {"site": "slow_step", "mode": "stall", "delay_s": 0.0, "count": 2},
    {"site": "logger.emit", "mode": "error"},
]
ENV_SPECS = '[{"site": "checkpoint.load", "mode": "error", "step": 5}]'
CALLS = [
    ("checkpoint.save", None, 1), ("writer.write", 0, None), ("checkpoint.save", None, 2),
    ("writer.write", 1, None), ("writer.write", 1, None), ("engine.admit", None, 2),
    ("engine.admit", None, 3), ("checkpoint.save", None, 3), ("slow_step", 0, 4),
    ("checkpoint.load", None, 4), ("checkpoint.load", None, 5), ("slow_step", 1, 8),
    ("slow_step", 2, 12), ("logger.emit", None, None), ("logger.emit", None, None),
    ("preempt", 0, 4),
]


def test_one_schedule_fires_alike_in_both_controllers(monkeypatch):
    monkeypatch.setenv("TRLX_CHAOS", ENV_SPECS)
    runs = {}
    for key, pkg in PACKAGES.items():
        ctl = pkg.chaos.ChaosController()
        ctl.configure([dict(s) for s in SPECS])
        outcomes = []
        for site, phase, step in CALLS:
            try:
                ctl.check(site, phase=phase, step=step)
                outcomes.append(None)
            except Exception as e:
                outcomes.append((type(e).__name__, getattr(e, "errno", None), str(e)))
        runs[key] = (outcomes, ctl.events(), ctl.active())
        ctl.clear()
        assert not ctl.active() and not ctl.events()
    assert runs["port"] == runs["jax"]
    assert sum(o is not None for o in runs["port"][0]) == 6


def test_env_specs_arm_without_a_config_list(monkeypatch):
    """``TRLX_CHAOS`` arms the schedule when the config's list is empty;
    a malformed value is refused in both packages alike."""
    monkeypatch.setenv("TRLX_CHAOS", ENV_SPECS)
    for pkg in PACKAGES.values():
        pkg.chaos.configure([])
        assert pkg.chaos.active()
        with pytest.raises(OSError):
            pkg.chaos.check("checkpoint.load", step=5)
        assert [e["site"] for e in pkg.chaos.events()] == ["checkpoint.load"]
    monkeypatch.setenv("TRLX_CHAOS", "not json")
    messages = []
    for pkg in PACKAGES.values():
        with pytest.raises(ValueError) as info:
            pkg.chaos.configure([])
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_guard_intercepts_sigterm_and_restores_the_handlers():
    def previous(signum, frame):
        raise AssertionError("the guard should have taken the signal")

    old_term = signal.signal(signal.SIGTERM, previous)
    old_int = signal.getsignal(signal.SIGINT)
    try:
        guard = tpre.install_guard(["SIGTERM", "SIGINT"])
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        assert not tpre.drain_requested()
        os.kill(os.getpid(), signal.SIGTERM)
        assert tpre.drain_requested() and tpre.received_signal() == "SIGTERM"
        tpre.clear_request()
        assert not tpre.drain_requested()
        tpre.uninstall_guard()
        assert signal.getsignal(signal.SIGTERM) is previous
        assert signal.getsignal(signal.SIGINT) is old_int
        assert not tpre.drain_requested()  # no guard: always False
        assert tpre.PreemptionDrain("p").exit_code == tpre.PREEMPTION_EXIT_CODE == 75
        with pytest.raises(ValueError, match="unknown signal"):
            tpre.PreemptionGuard(["SIGNOPE"])
    finally:
        tpre.uninstall_guard()
        signal.signal(signal.SIGTERM, old_term)


# ------------------------------ the writers ------------------------------ #

WRITER_CASES = {
    # (writer.write specs, [(file, n_rows) submits and "flush" marks])
    "disk_full_three_times": ([{"site": "writer.write", "mode": "disk_full", "count": 3}],
                              [("a", 3), ("b", 2), "flush", ("a", 4), ("b", 1), "flush",
                               ("a", 2)]),
    "two_transient_then_recovers": ([{"site": "writer.write", "mode": "error", "count": 2}],
                                    [("a", 2), "flush", ("a", 3), ("b", 2)]),
    "no_failure": ([], [("a", 5), ("b", 5), "flush", ("a", 1)]),
    "never_recovers": ([{"site": "writer.write", "mode": "disk_full", "count": 50}],
                       [("a", 2), "flush", ("b", 2)]),
    "missing_directory": ([], [("a", 2), ("missing/c", 1), "flush", ("a", 1)]),
}


@pytest.mark.parametrize("name", list(WRITER_CASES))
def test_writers_land_the_same_rows_in_order(tmp_path, name):
    specs, script = WRITER_CASES[name]
    runs = {}
    for key, pkg in PACKAGES.items():
        root = tmp_path / key
        root.mkdir()
        pkg.chaos.configure([dict(s) for s in specs])
        writer = pkg.writer.BackgroundJSONLWriter()
        raised, n = [], 0
        for step in script:
            try:
                if step == "flush":
                    writer.flush()
                else:
                    path, rows = step
                    writer.submit(str(root / f"{path}.jsonl"),
                                  [{"row": n + i, "file": path} for i in range(rows)])
                    n += rows
            except RuntimeError as e:
                raised.append((str(step), type(e.__cause__).__name__))
        try:
            writer.close()
        except RuntimeError as e:
            raised.append(("close", type(e.__cause__).__name__, str(e)))
        pkg.chaos.clear()
        files = {f: (root / f"{f}.jsonl").read_text()
                 for f in ("a", "b") if (root / f"{f}.jsonl").exists()}
        runs[key] = (files, writer.degraded, raised)
    assert runs["port"] == runs["jax"]
    files, degraded, raised = runs["port"]
    if name == "disk_full_three_times":
        assert degraded and not raised
        rows = [int(line.split('"row": ')[1].split(",")[0])
                for f in ("a", "b") for line in files[f].splitlines()]
        assert sorted(rows) == list(range(12))
    if name == "never_recovers":
        assert raised and raised[-1][0] == "close"


# ------------------------------ the supervisor --------------------------- #

SUPERVISED = {
    # (resilience, outcomes of the attempts in turn: None succeeds)
    "disabled_runs_once": ({}, ["io", None]),
    "transient_then_succeeds": ({"enabled": True, "max_restarts": 2, "restart_delay_s": 0.5},
                                ["io", "preempt", None]),
    "budget_exhausted": ({"enabled": True, "max_restarts": 1, "restart_delay_s": 0.25},
                         ["preempt", "abort", None]),
    "permanent_at_once": ({"enabled": True}, ["value", None]),
    "preemption_not_resumed": ({"enabled": True, "resume_on_preemption": False},
                               ["preempt", None]),
    "keyboard_interrupt_never_eaten": ({"enabled": True}, ["interrupt", None]),
}


@pytest.mark.parametrize("checkpointed", [False, True])
@pytest.mark.parametrize("name", list(SUPERVISED))
def test_supervisors_restart_alike(tmp_path, name, checkpointed):
    resilience, outcomes = SUPERVISED[name]
    handlers = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    runs = {}
    for key, pkg in PACKAGES.items():
        ckpt = tmp_path / key
        if checkpointed:  # a committed step in both layouts
            (ckpt / "4").mkdir(parents=True)
            (ckpt / "4" / tckpt.STATE_FILE).write_bytes(b"")
        config = SimpleNamespace(train=SimpleNamespace(
            resilience=dict(resilience), resume_from_checkpoint=False,
            checkpoint_dir=str(ckpt)))
        errors = {"io": lambda: OSError(errno.EIO, "flaky"),
                  "preempt": lambda: pkg.drain("preempted", step=4),
                  "abort": lambda: pkg.abort("aborted"),
                  "value": lambda: ValueError("config error"),
                  "interrupt": lambda: KeyboardInterrupt()}
        resumes, sleeps = [], []

        def attempt(resume):
            resumes.append(resume)
            outcome = outcomes[len(resumes) - 1]
            if outcome is not None:
                raise errors[outcome]()
            return "done"

        try:
            out = pkg.sup.run_supervised(attempt, config, sleep=sleeps.append)
        except BaseException as e:
            out = (type(e).__name__, type(e.__cause__).__name__ if e.__cause__ else None)
        runs[key] = (out, resumes, sleeps)
        assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == handlers
    assert runs["port"] == runs["jax"]


# --------------------------- checkpoint and server ------------------------ #


def test_checkpoint_io_retries_and_refuses_through_the_sites(tmp_path):
    """``checkpoint.save`` failing twice retries twice (synchronously, and
    on the writer thread under ``async_save``); ``checkpoint.load``
    failing transiently retries, and a permanent one refuses at once with
    the translated error; a permanent save error surfaces at the join."""
    tretry.set_default_policy(tretry.RetryPolicy(base_delay_s=0.001))
    state = {"w": torch.arange(4.0), "step": 1}
    writer = tckpt.CheckpointWriter()
    for async_save in (False, True):
        tretry.reset_retry_log()
        directory = str(tmp_path / f"async_{async_save}")
        tchaos.configure([{"site": "checkpoint.save", "mode": "error", "count": 2}])
        writer.save(directory, state, 1, async_save=async_save)
        writer.wait()
        assert [r["what"] for r in tretry.retry_log] == [f"checkpoint save to {directory}"] * 2
        assert tckpt.has_checkpoint(directory) and tckpt.all_steps(directory) == [1]
    tretry.reset_retry_log()
    tchaos.configure([{"site": "checkpoint.load", "mode": "error", "count": 1}])
    assert torch.equal(tckpt.load_checkpoint(directory)["w"], state["w"])
    assert len(tretry.retry_log) == 1
    tretry.reset_retry_log()
    tchaos.configure([{"site": "checkpoint.load", "mode": "permanent"}])
    with pytest.raises(ValueError, match="num_layers_unfrozen"):
        tckpt.load_checkpoint(directory)
    assert not tretry.retry_log
    tchaos.configure([{"site": "checkpoint.save", "mode": "permanent"}])
    writer.save(directory, dict(state, step=2), 2, async_save=True)
    with pytest.raises(ValueError, match="structure mismatch"):
        writer.wait()
    assert not tretry.retry_log and tckpt.all_steps(directory) == [1]
    assert not tckpt.has_checkpoint(str(tmp_path / "nothing"))


def _server_config():
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    cfg["train"]["dtype"] = "float32"
    cfg["train"]["rollout"] = {"engine": "continuous", "slots": 8, "admit_width": 4,
                               "harvest_width": 4, "block_size": 4}
    cfg["method"]["gen_kwargs"]["do_sample"] = False
    return cfg


def test_server_admission_retries_and_rolls_back_the_pool():
    from trlx_tpu_torch.inference.server import InferenceServer

    tretry.set_default_policy(tretry.RetryPolicy(base_delay_s=0.001))
    server = InferenceServer(_server_config(), device="cpu",
                             serving={"prefix_cache_blocks": 8})
    pool = server.prefix_pool
    prompt = list(range(1, 9))
    tchaos.configure([{"site": "engine.admit", "mode": "permanent"}])
    with pytest.raises(ValueError, match="structure mismatch"):
        server.generate([prompt] * 2)
    # the failed plans let go of their references and never-ready blocks
    assert not pool._nodes and pool.free_blocks == pool.pool_blocks
    assert not tretry.retry_log
    tchaos.configure([{"site": "engine.admit", "mode": "error", "count": 2}])
    server = InferenceServer(_server_config(), device="cpu",
                             serving={"prefix_cache_blocks": 8})
    results = server.generate([prompt] * 2)
    assert len(results) == 2 and all(r["length"] >= 1 for r in results)
    assert [r["what"] for r in tretry.retry_log] == ["inference-server admission"] * 2
    assert all(node.refcount == 0 and node.ready for node in server.prefix_pool._nodes.values())


# ------------------------ preempt / resume canaries ----------------------- #

ARCH = {"vocab_size": 32, "n_positions": 16, "n_embd": 16, "n_layer": 1, "n_head": 2}
PREEMPT = {"site": "preempt", "mode": "preempt"}


def _ppo_config(ckpt, resilience=None, **train) -> dict:
    """``tests/test_resume.py``'s shape, greedy: 2-update phases of 16
    rollouts, 6 updates."""
    return {
        "model": {"model_type": "gpt2", "model_arch": dict(ARCH)},
        "train": {"seq_length": 4, "batch_size": 8, "epochs": 8, "total_steps": 6,
                  "lr_init": 1e-3, "lr_target": 2e-4, "eval_interval": 10000,
                  "checkpoint_interval": 100000, "checkpoint_dir": str(ckpt),
                  "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32",
                  "resilience": resilience or {}, **train},
        "method": {"name": "PPOConfig", "num_rollouts": 16, "chunk_size": 8, "ppo_epochs": 1,
                   "gen_kwargs": {"max_new_tokens": 2, "do_sample": False,
                                  "eos_token_id": 30, "pad_token_id": 31}},
    }


def _ilql_config(ckpt, resilience=None, **train) -> dict:
    """``tests/test_resilience.py``'s ILQL shape: 4 minibatches an epoch, 8
    updates, the first chunk boundary at 4; sampled evals."""
    return {
        "model": {"model_type": "gpt2", "model_arch": dict(ARCH)},
        "train": {"seq_length": 6, "batch_size": 8, "epochs": 2, "total_steps": 8,
                  "lr_init": 1e-3, "lr_target": 1e-3, "eval_interval": 10000,
                  "checkpoint_interval": 100000, "trainer": "ILQLTrainer",
                  "orchestrator": "OfflineOrchestrator", "checkpoint_dir": str(ckpt),
                  "mesh": {"dp": -1, "fsdp": 1, "tp": 1}, "dtype": "float32",
                  "resilience": resilience or {}, **train},
        "method": {"name": "ILQLConfig", "two_qs": True, "steps_for_target_q_sync": 2,
                   "gen_kwargs": {"max_new_tokens": 2, "do_sample": True,
                                  "eos_token_id": 30, "pad_token_id": 31}},
    }


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(1, 30, size=3)] for _ in range(16)]


def _reward(samples, queries, response_gt=None):
    return [float(len(s)) for s in samples]


def _dataset():
    rng = np.random.default_rng(0)
    samples = [([int(t) for t in rng.integers(1, 30, size=5)], 2) for _ in range(32)]
    return samples, [float(r) for r in rng.random(32)]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _train_port(cfg: dict, offline: bool, attempts: list, configs=None, prompts=None):
    """``trlx_tpu_torch.train`` on the CPU; ``attempts`` gets the resume
    flag of each attempt the supervisor runs, ``configs`` (when given) the
    ``TRLConfig`` the caller passed; ``prompts`` replace the canaries'."""
    import trlx_tpu_torch
    from trlx_tpu_torch import api
    from trlx_tpu_torch.data.configs import TRLConfig

    supervised = api.run_supervised

    def counting(attempt, config):
        return supervised(lambda resume: attempts.append(resume) or attempt(resume), config)

    config = TRLConfig.from_dict(cfg)
    if configs is not None:
        configs.append(config)
    api.run_supervised = counting
    try:
        if offline:
            trainer = trlx_tpu_torch.train(dataset=_dataset(), config=config, device="cpu")
        else:
            trainer = trlx_tpu_torch.train(reward_fn=_reward,
                                           prompts=prompts or _prompts(),
                                           config=config, device="cpu")
    finally:
        api.run_supervised = supervised
    return trainer


def _state(trainer) -> dict:
    """What a resumed run must reproduce exactly."""
    opt = trainer.opt.state_dict()
    out = {f"model.{n}": t for n, t in trainer.model.state_dict().items()}
    out.update({f"adam.{i}.{k}": v for i, st in opt["adamw"]["state"].items()
                for k, v in st.items() if torch.is_tensor(v)})
    out["generator"] = trainer.generator.get_state()
    if hasattr(trainer, "target"):
        out.update({f"target.{n}": t for n, t in trainer.target.state_dict().items()})
    out["counters"] = torch.tensor([trainer.step, opt["count"],
                                    getattr(trainer, "kl_coef", 0.0),
                                    getattr(trainer, "mean_kl", 0.0)], dtype=torch.float64)
    return out


@pytest.fixture(scope="module")
def canaries(tmp_path_factory):
    """Per method: the JAX package's resumed run (its initial parameters
    recorded), and the port's uninterrupted and resumed runs from them."""
    import trlx_tpu
    from trlx_tpu.data.configs import TRLConfig as JConfig
    from trlx_tpu.trainer.ilql_trainer import ILQLTrainer as JILQL
    from trlx_tpu.trainer.ppo_trainer import PPOTrainer as JPPO
    from trlx_tpu_torch.trainer import ilql_trainer as tilql
    from trlx_tpu_torch.trainer import ppo_trainer as tppo

    os.environ["WANDB_DISABLED"] = "1"
    tmp = tmp_path_factory.mktemp("canary")
    out = {}
    for method, cls, module, make_cfg, phase in (
            ("ppo", JPPO, tppo, _ppo_config, 1), ("ilql", JILQL, tilql, _ilql_config, 0)):
        offline = method == "ilql"
        inits = []
        with pytest.MonkeyPatch.context() as mp:
            init = cls.__init__

            def recording(self, *a, **kw):
                init(self, *a, **kw)
                if not inits:
                    inits.append({"params": _numpy(self.state.params),
                                  "target": _numpy(getattr(self.state, "target_q_params", {}))})

            mp.setattr(cls, "__init__", recording)
            preempted = {"enabled": True, "chaos": [dict(PREEMPT, phase=phase)]}
            jcfg = JConfig.from_dict(make_cfg(tmp / f"{method}_jax", preempted))
            if offline:
                jt = trlx_tpu.train(dataset=_dataset(), config=jcfg)
            else:
                jt = trlx_tpu.train(reward_fn=_reward, prompts=_prompts(), config=jcfg)
        jax_run = {"init": inits[0]["params"], "params": _numpy(jt.state.params),
                   "step": int(jt.state.step),
                   "target": _numpy(getattr(jt.state, "target_q_params", {}))}
        runs = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "init_params",
                       lambda model, seed: model.load_state_dict(flax_to_torch(inits[0]["params"])))
            for name, cfg in (("plain", make_cfg(tmp / f"{method}_plain")),
                              ("resumed", make_cfg(tmp / f"{method}_resumed", preempted,
                                                   async_checkpoint=True))):
                attempts, configs = [], []
                runs[name] = (_train_port(cfg, offline, attempts, configs), attempts,
                              dict(configs[0].train.training))
        out[method] = {"jax": jax_run, "cfg": make_cfg(tmp / f"{method}_plain"),
                       **{k: {"trainer": t, "attempts": a, "state": _state(t),
                              "training_after": training}
                          for k, (t, a, training) in runs.items()}}
    return out


@pytest.mark.parametrize("method", ["ppo", "ilql"])
def test_preempted_run_resumes_bit_for_bit(canaries, method):
    run = canaries[method]
    plain, resumed = run["plain"], run["resumed"]
    # the preempted run drained and was resumed once; the plain one ran once
    assert plain["attempts"] == [False] and resumed["attempts"] == [False, True]
    assert set(resumed["state"]) == set(plain["state"])
    for key, want in plain["state"].items():
        assert torch.equal(resumed["state"][key], want), key
    assert resumed["trainer"].step == plain["trainer"].step == run["jax"]["step"]
    assert tpre._guard is None and not tchaos.active()


@pytest.mark.parametrize("method", ["ppo", "ilql"])
def test_supervised_restart_leaves_the_callers_config_as_given(canaries, method):
    """Each attempt sets ``resume_from_checkpoint``; after the restart the
    caller's config is back as it was passed (the key unset), so a later
    ``train`` with it starts afresh instead of resuming this run."""
    run = canaries[method]
    assert run["resumed"]["attempts"] == [False, True]
    for name in ("plain", "resumed"):
        training = run[name]["training_after"]
        assert "resume_from_checkpoint" not in training, name


T5_ARCH = {  # tests/test_torch_seq2seq_ppo_trainer.py's
    "vocab_size": 40, "d_model": 32, "d_kv": 8, "d_ff": 48, "num_layers": 2,
    "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 8,
    "relative_attention_max_distance": 16, "feed_forward_proj": "gated-gelu",
    "tie_word_embeddings": False,
}


def _grpo_config(ckpt, resilience=None, **train) -> dict:
    cfg = _ppo_config(ckpt, resilience, trainer="GRPOTrainer", total_steps=4, **train)
    cfg["method"].update(name="GRPOConfig", group_size=4, vf_coef=0.0, scale_reward=None)
    cfg["method"]["gen_kwargs"]["do_sample"] = True
    return cfg


def _seq2seq_config(ckpt, resilience=None, **train) -> dict:
    """T5 keeps its masters (no rollout cast) and samples on its own
    decoder path."""
    cfg = _ppo_config(ckpt, resilience, trainer="Seq2SeqPPOTrainer", total_steps=4,
                      seq_length=8, **train)
    cfg["model"] = {"model_type": "t5", "model_arch": dict(T5_ARCH)}
    cfg["method"]["gen_kwargs"] = {"max_new_tokens": 5, "min_length": 3, "do_sample": True,
                                   "eos_token_id": 1, "pad_token_id": 0,
                                   "forced_bos_token_id": 9}
    return cfg


@pytest.mark.parametrize("make_config", [_grpo_config, _seq2seq_config],
                         ids=["grpo", "seq2seq"])
def test_grpo_and_seq2seq_resume_bit_for_bit(tmp_path, make_config):
    """The trainers that inherit PPO's ``learn`` resume as it does: a
    sampled run preempted at its first pass boundary (update 2 of 4) and
    resumed under ``async_checkpoint`` ends ``torch.equal`` to the
    uninterrupted run."""
    plain_attempts, resumed_attempts = [], []
    plain = _train_port(make_config(tmp_path / "plain"), False, plain_attempts)
    resumed = _train_port(make_config(
        tmp_path / "resumed", {"enabled": True, "chaos": [dict(PREEMPT, phase=0)]},
        async_checkpoint=True), False, resumed_attempts)
    assert plain_attempts == [False] and resumed_attempts == [False, True]
    want, got = _state(plain), _state(resumed)
    assert set(got) == set(want) and plain.step == 4
    for key, t in want.items():
        assert torch.equal(got[key], t), key


@pytest.mark.parametrize("method", ["ppo", "ilql"])
def test_resumed_run_matches_the_jax_packages_resumed_run(canaries, method):
    run = canaries[method]
    trainer = run["resumed"]["trainer"]
    got = {n: t.detach() for n, t in trainer.model.state_dict().items()}
    moved = assert_final_params_match(got, run["jax"], run["cfg"])
    assert moved > 1e-4  # the runs trained
    if method == "ilql":
        want = flax_to_torch(run["jax"]["target"])
        for name, t in trainer.target.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-5, rtol=0)


def test_finished_run_resumes_without_collecting(canaries):
    """A resumed run whose checkpoint is at ``total_steps`` loads and
    returns: no collect phase, no update, the saved state."""
    run = canaries["ppo"]
    cfg = dict(run["cfg"], train=dict(run["cfg"]["train"], resume_from_checkpoint=True))
    attempts = []
    trainer = _train_port(cfg, False, attempts)
    assert attempts == [True] and trainer.phase_times == [] and trainer.step == 6
    want = run["plain"]["state"]
    for key, t in _state(trainer).items():
        if key != "generator":  # saved before the final eval's draws
            assert torch.equal(t, want[key]), key


def test_async_sentiments_yml_is_refused_only_for_async_rl(tmp_path):
    """``configs/ppo_async_sentiments.yml`` (``async_rl`` at
    ``staleness_window: 1`` on the continuous engine, ``health``,
    ``resilience``), once refused for ``async_rl`` alone, runs through
    ``trlx_tpu_torch.train`` on the CPU under the supervisor: its model a
    local HF-layout GPT-2 checkpoint at a tiny width (GPT-2's vocabulary
    kept: the yml's ids are GPT-2's), cut to one pass of 32 rollouts (8
    updates) of 8 new tokens (its ``min_new_tokens`` = ``max_new_tokens``
    kept equal) after 8-token prompts, without a tokenizer: 32 rollouts
    fill the 16 slots twice, so the first minibatch trains while rows are
    still queued, and its update is pushed. One injected ``engine.admit``
    failure kills the first attempt's actor: an ``ActorDeadError``, which
    the supervisor retries from scratch (no checkpoint yet); the second
    attempt trains with weights pushed mid-phase and no staleness
    breach."""
    import chip_smoke
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from trlx_tpu_torch.trainer import ppo_trainer as tppo
    from trlx_tpu_torch.trainer.async_rl import ActorDeadError

    hf = dict(chip_smoke.GPT2_HF_CONFIG, n_positions=128, n_embd=16, n_layer=2, n_head=2)
    backbone = GPT2Model(GPT2Config.from_dict(hf), device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in backbone.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    chip_smoke.write_hf_checkpoint(str(tmp_path / "gpt2_tiny"), hf,
                                   chip_smoke.gpt2_hf_layout(backbone.state_dict()))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ppo_async_sentiments.yml")).to_dict()
    assert cfg["train"]["async_rl"] == {"enabled": True, "staleness_window": 1,
                                        "actor_fraction": 1.0}
    cfg["model"].update(model_path=str(tmp_path / "gpt2_tiny"), tokenizer_path="")
    cfg["method"]["num_rollouts"] = 32
    cfg["method"]["gen_kwargs"].update(max_new_tokens=8, min_new_tokens=8)
    cfg["train"].update(seq_length=8, total_steps=8, checkpoint_dir=str(tmp_path / "ckpt"))
    cfg["train"]["resilience"] = dict(
        cfg["train"]["resilience"],
        chaos=[{"site": "engine.admit", "mode": "error", "count": 1}])
    failures, finished = [], []
    with pytest.MonkeyPatch.context() as mp:
        learn = tppo.PPOTrainer.learn

        def recorded(self):
            try:
                out = learn(self)
            except ActorDeadError:
                failures.append(dict(self.health_monitor.event_counts))
                raise
            finished.append(dict(self._last_overlap_stats))
            return out

        mp.setattr(tppo.PPOTrainer, "learn", recorded)
        attempts = []
        prompts = [[int(t) for t in np.random.default_rng(i).integers(1, 50000, size=8)]
                   for i in range(32)]
        trainer = _train_port(cfg, False, attempts, prompts=prompts)
    assert attempts == [False, False]  # the first attempt died before any save
    assert failures == [{"actor-dead": 1}]
    assert trainer.step == 8 and trainer.rollout_engine == "continuous"
    stats = finished[-1]
    assert stats["async/weight_pushes"] > 0 and 0 < stats["async/staleness_max"] <= 1
    assert not trainer.health_monitor.event_counts.get("staleness-breach")
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_supervised_train_keeps_cuda_as_the_default_device(tmp_path):
    """``device=None`` means CUDA in every supervised attempt: without a
    card the first attempt raises (a permanent failure, no restart), and
    the handlers come back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    handlers = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    cfg = TRLConfig.from_dict(_ppo_config(tmp_path, {"enabled": True, "max_restarts": 3}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trlx_tpu_torch.train(reward_fn=_reward, prompts=_prompts(), config=cfg)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == handlers


def test_frozen_layout_mismatch_refuses_at_once(tmp_path):
    """A checkpoint written under ``num_layers_unfrozen: 1`` resumed into a
    fully trainable run raises the translated ``ValueError``: no retry, no
    restart."""
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.trainer.ppo_trainer import PPOTrainer

    cfg = _ppo_config(tmp_path / "ckpt", {"enabled": True}, resume_from_checkpoint=True)
    cfg["model"]["model_arch"]["n_layer"] = 2
    frozen = dict(cfg, model=dict(cfg["model"], num_layers_unfrozen=1))
    PPOTrainer(TRLConfig.from_dict(frozen), device="cpu").save()
    attempts = []
    with pytest.raises(ValueError, match="num_layers_unfrozen") as info:
        _train_port(cfg, False, attempts)
    assert "doesn't match the size of optimizer's group" in str(info.value)
    assert attempts == [True] and not tretry.retry_log and tpre._guard is None
