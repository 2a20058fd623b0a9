"""One rank of ``tests/test_torch_mesh_training.py``'s gloo worlds.

``RANK=r WORLD_SIZE=n python tests/_torch_mesh_worker.py TASK STORE OUT``
starts the rank's gloo group through
``trlx_tpu_torch.parallel.distributed.initialize`` (the rendezvous through
the ``file://`` store ``STORE``) and runs each case of the task file
``TASK`` (``torch.save`` of ``{"cases": [...]}``): the port's PPO or GRPO
trainer on the case's config, its parameters loaded from the case's
``init`` (a one-device state dict) where the trainer draws its initial
weights, its sampler handed the case's ``noise`` (per sample call, the
global batch's Gumbel draws per step, which the sampler slices to the
rank's rows), then ``learn()`` twice: streamed (``phase_overlap``'s
default) and with every phase's epoch-1 updates held to its end
(``overlap=False``). It records, in the one-device layout, the final
parameters, the smallest nonzero gradient magnitude of every element over
the updates, the global rollout store, the phase's stats rows, the KL
sequence, the bytes each parameter holds on this rank, whether the two
schedules' shards are ``torch.equal`` (each run's end checkpoint lands in
its ``train.checkpoint_dir``, the serial run's with ``_serial`` added),
and with ``load`` the parameters and moments a fresh trainer restores from
a checkpoint directory. A ``"kind": "stats"`` case runs the collectives'
global statistics instead (:func:`run_stats`), a ``"kind": "model"``
case one family's sharded forward and backward (:func:`run_model`). Imports only torch, numpy
and the port, so the rank's process never loads JAX. The record goes to
``OUT/rank<r>.pt``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from trlx_tpu_torch.data.configs import TRLConfig
from trlx_tpu_torch.parallel import distributed
from trlx_tpu_torch.trainer import ppo_trainer
from trlx_tpu_torch.utils.loading import get_orchestrator, get_pipeline, get_trainer

BUFFER_KEYS = ("query_tokens", "query_mask", "response_tokens", "response_mask",
               "logprobs", "values", "rewards")


def prompts():
    """``tests/_torch_ppo_phase.py``'s prompts."""
    rng = np.random.default_rng(9)
    return [[int(x) for x in rng.integers(0, 36, int(rng.integers(1, 7)))] for _ in range(24)]


def reward_fn(samples, queries, response_gt=None):
    """``tests/test_torch_grpo.py``'s tie-free reward (also the PPO cases'):
    a pure function of the response ids."""
    return [float(np.mean([np.sin(1.7 * int(t) + 0.3 * i) for i, t in enumerate(s.split())]))
            if s else 0.0 for s in samples]


def inject(trainer, noise) -> None:
    """Hand the sampler the task's draws, call by call: each call's
    ``noise[call][t]`` is the global batch's [B, V] at step ``t``."""
    calls = iter(noise)
    real = trainer._sampler

    def sample(ids, mask, generator=None, shard=None, **_):
        chain = next(calls)
        return real(ids, mask, noise_fn=lambda t: chain[t], shard=shard)

    trainer._sampler = sample


def build(cfg: dict, init):
    """The trainer of ``cfg`` with a bound pipeline and orchestrator, its
    initial parameters ``init`` (the trainer shards them)."""
    orig = ppo_trainer.init_params

    def load_init(model, seed):
        model.load_state_dict(init)

    ppo_trainer.init_params = load_init
    try:
        config = TRLConfig.from_dict(cfg)
        trainer = get_trainer(config.train.trainer)(config, reward_fn=reward_fn, device="cpu")
    finally:
        ppo_trainer.init_params = orig
    pipeline = get_pipeline("PromptPipeline")(prompts(), trainer.query_length)
    get_orchestrator("PPOOrchestrator")(trainer, pipeline, reward_fn=reward_fn,
                                        chunk_size=config.method.chunk_size)
    trainer.add_eval_pipeline(pipeline)
    return trainer


def record_floor(trainer) -> dict:
    """Per element of each trainable shard, its smallest nonzero synced
    gradient magnitude over the updates (filled as they run)."""
    floor, step = {}, trainer.opt.step
    names = {id(p): n for n, p in trainer.model.named_parameters()}

    def recorded_step():
        for p in trainer.opt.params:
            if p.grad is not None:
                g = p.grad.abs().masked_fill(p.grad == 0, float("inf"))
                n = names[id(p)]
                floor[n] = torch.minimum(floor[n], g) if n in floor else g
        return step()

    trainer.opt.step = recorded_step
    return floor


def learn(cfg, init, noise, overlap=None):
    if overlap is False:  # its end checkpoint beside the streamed run's
        cfg = {**cfg, "train": {**cfg["train"],
                                "checkpoint_dir": cfg["train"]["checkpoint_dir"] + "_serial"}}
    trainer = build(cfg, init)
    inject(trainer, noise)
    phases = []
    train_on = trainer._train_on

    def recorded(*a, **kw):
        out = train_on(*a, **kw)
        phases.append(out)
        return out

    trainer._train_on = recorded
    if overlap is False:
        begin = trainer.begin_streamed_phase

        def serial(seed=0, num_rollouts=None, overlap=None):
            return begin(seed=seed, num_rollouts=num_rollouts, overlap=False)

        trainer.begin_streamed_phase = serial
    floor = record_floor(trainer)
    trainer.learn()
    return trainer, phases, floor


def run_stats(case: dict) -> dict:
    """The collectives' statistics over the data group of ``{dp: -1}``:
    each rank's rows of ``x`` and ``mask``, and each batch of ``scores``
    through one ``RunningMoments`` (the rank's rows of each)."""
    from trlx_tpu_torch.parallel import collectives as C
    from trlx_tpu_torch.parallel.mesh import MeshGroups, mesh_sizes

    g = MeshGroups(mesh_sizes({"dp": -1}, dist.get_world_size()))
    x, mask = case["x"], case["mask"]
    rows = g.rows(x.shape[0])
    xl, ml = x[rows], mask[rows]
    out = {"name": case["name"], "rows": (rows.start, rows.stop)}
    out["whiten"] = C.whiten(xl, ml, group=g.data_group)
    out["whiten_keep_mean"] = C.whiten(xl, ml, shift_mean=False, group=g.data_group)
    out["mean"] = C.masked_mean(xl, ml, group=g.data_group)
    out["var"] = C.masked_var(xl, ml, group=g.data_group)
    out["mean_unmasked"] = C.masked_mean(xl, group=g.data_group)
    moments = C.RunningMoments()
    out["moments"] = []
    for scores in case["scores"]:
        batch = moments.update(scores[g.rows(len(scores))], group=g.data_group)
        out["moments"].append((batch, moments.mean, moments.std, moments.var, moments.count))
    out["gathered"] = g.gather_rows(xl)
    out["objects"] = g.gather_data_objects(("rank", g.rank))
    return out


def run_model(case: dict) -> dict:
    """One family's policy (value head included) under the case's mesh:
    the full state dict ``init`` sharded as the trainers shard it, a
    forward of each rank's rows of ``ids`` and the backward of ``sum(logits
    * weights) + sum(values²)``; returns the gathered logits and values and
    every parameter's synced gradient in the one-device layout."""
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead
    from trlx_tpu_torch.models.registry import get_model_family
    from trlx_tpu_torch.parallel.mesh import MeshGroups, mesh_sizes
    from trlx_tpu_torch.parallel.partition import (
        ShardedModule,
        apply_tensor_parallel,
        make_shardings,
    )

    family = get_model_family(case["family"])
    model = CausalLMWithValueHead(family.config_cls.from_dict(case["arch"]),
                                  family.backbone_cls, device="cpu")
    model.load_state_dict(case["init"])
    g = MeshGroups(mesh_sizes(case["mesh"], dist.get_world_size()))
    placements = make_shardings(model, g.sizes, family.partition_rules, family.tp_fused)
    sharded = ShardedModule(model, apply_tensor_parallel(model, placements, g), g)
    rows = g.rows(case["ids"].shape[0])
    with sharded.unsharded(grad=True):
        out = model(case["ids"][rows], attention_mask=case["mask"][rows])
        loss = (out["logits"] * case["weights"][rows]).sum() + (out["values"] ** 2).sum()
        loss.backward()
    sharded.sync_grads(list(model.parameters()))
    return {"name": case["name"], "logits": g.gather_rows(out["logits"].detach()),
            "values": g.gather_rows(out["values"].detach()),
            "grads": {n: sharded.full_tensor(n, p.grad) for n, p in model.named_parameters()},
            "bytes": sharded.shard_bytes()}


def run_case(case: dict) -> dict:
    if case.get("kind") == "stats":
        return run_stats(case)
    if case.get("kind") == "model":
        return run_model(case)
    cfg, init, noise = case["cfg"], case["init"], case["noise"]
    out = {"name": case["name"]}
    if case.get("load"):
        trainer = build(cfg, init)
        trainer.load(case["load"])
        out["loaded_params"] = trainer.shards.full_state_dict()
        out["loaded_opt"] = trainer._full_opt_state()
        out["loaded_step"] = trainer.step
        return out
    streamed, phases, floor = learn(cfg, init, noise)
    serial, _, _ = learn(cfg, init, noise, overlap=False)
    out["serial_equal"] = all(
        torch.equal(p, q) for p, q in zip(streamed.model.parameters(), serial.model.parameters()))
    out["serial_equal"] &= streamed.kl_coef == serial.kl_coef
    sh = streamed.shards
    out["params"] = sh.full_state_dict()
    out["floor"] = {n: sh.full_tensor(n, f) for n, f in sorted(floor.items())}
    buf = streamed.buffer.full
    out["buffer"] = {k: getattr(buf, k).clone() for k in BUFFER_KEYS}
    out["rows"] = phases[0][0]
    out["kl_seq"] = phases[0][1]
    out["bytes"] = sh.shard_bytes()
    out["ref_bytes"] = streamed.ref_shards.shard_bytes()
    out["specs"] = {n: pl.spec for n, pl in sh.placements.items()}
    out["trainable"] = [n for n, p in streamed.model.named_parameters() if p.requires_grad]
    out["opt_bytes"] = sum(t.numel() * t.element_size()
                           for st in streamed.opt.adamw.state.values()
                           for t in st.values() if torch.is_tensor(t) and t.dim() > 0)
    out["forwards"] = streamed.forwards
    return out


def spawn(tasks: dict, tmp, timeout: float = 300) -> dict:
    """Run ``tasks`` (``{world size: [case, ...]}``), every world's ranks
    at once, each world on its own ``file://`` store under ``tmp`` with
    one thread a rank; returns ``{case name: [each rank's record]}``."""
    import subprocess

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    procs = []
    for world, cases in tasks.items():
        wdir = tmp / f"world{world}"
        wdir.mkdir()
        torch.save({"cases": cases}, wdir / "task.pt")
        for r in range(world):
            procs.append((wdir, r, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(wdir / "task.pt"),
                 str(wdir / "store"), str(wdir)],
                env={**env, "RANK": str(r), "WORLD_SIZE": str(world)},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    try:
        for _, _, p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for _, _, p in procs:
            p.kill()
    if any(p.returncode for _, _, p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(logs)[-20000:])
    out: dict = {}
    for wdir, r, _ in procs:
        for rec in torch.load(wdir / f"rank{r}.pt", weights_only=False):
            out.setdefault(rec["name"], []).append(rec)
    return out


def main() -> int:
    task, store, out_dir = sys.argv[1], sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    if not distributed.initialize("cpu", init_method=f"file://{store}"):
        raise RuntimeError("initialize started no process group")
    try:
        records = [run_case(case) for case in torch.load(task, weights_only=False)["cases"]]
    finally:
        dist.destroy_process_group()
    torch.save(records, os.path.join(out_dir, f"rank{int(os.environ['RANK'])}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
