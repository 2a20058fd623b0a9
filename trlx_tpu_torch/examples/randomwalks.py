"""Synthetic random walks: shortest-path finding on a random graph (the
port's copy of ``examples/randomwalks.py``, the reference's CI-speed PPO
task, ``examples/randomwalks/randomwalks.py``).

The model sees a start node and generates a walk; the reward is the walk's
optimality, the shortest length over the taken length (0 for an invalid
edge or a walk that never reaches the goal). Node i is token i,
``n_nodes`` is eos and ``n_nodes + 1`` pad; a prompt is one start node;
samples decode as space-joined ints.

``main(overrides)`` trains ``configs/ppo_randomwalks.yml`` with the
overrides applied (``TRLConfig.update``) and returns the trainer's final
stats, ``metrics/optimality`` among them: the sweep's trainable
(``python -m trlx_tpu_torch.sweep trlx_tpu_torch/examples/randomwalks.py
--config configs/sweeps/ppo_randomwalks_sweep.yml``).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:  # run as a script, or loaded by file by the sweep CLI
    sys.path.insert(0, ROOT)


def generate_graph(n_nodes: int = 21, p_edge: float = 0.1, seed: int = 1002) -> np.ndarray:
    """A random directed adjacency with a ring backbone, so every node
    reaches the goal."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n_nodes, n_nodes)) < p_edge
    np.fill_diagonal(adj, False)
    for i in range(n_nodes):
        adj[i, (i + 1) % n_nodes] = True
    return adj


def shortest_lengths(adj: np.ndarray, goal: int = 0) -> np.ndarray:
    """BFS distances to ``goal`` along the edges."""
    dist = np.full(adj.shape[0], np.inf)
    dist[goal] = 0
    frontier = [goal]
    while frontier:
        nxt = []
        for v in frontier:
            for u in np.nonzero(adj[:, v])[0]:
                if dist[u] == np.inf:
                    dist[u] = dist[v] + 1
                    nxt.append(u)
        frontier = nxt
    return dist


def make_task(n_nodes: int = 21, walk_length: int = 9, seed: int = 1002):
    """``(reward_fn, metric_fn, prompts, logit_mask, info)``; the logit mask
    is the adjacency, for ILQL's eval decode."""
    goal = 0
    adj = generate_graph(n_nodes, seed=seed)
    dists = shortest_lengths(adj, goal)

    def walk_score(sample: str, query: str) -> float:
        start = int(query.split()[-1])
        walk = [start]
        for tok in sample.split():
            if int(tok) >= n_nodes:
                break
            walk.append(int(tok))
        length = 0.0
        for u, v in zip(walk[:-1], walk[1:]):
            if not adj[u, v]:
                return 0.0  # an invalid edge: the walk never finishes
            length += 1
            if v == goal:
                return float(dists[start] / length)
        return 0.0

    def reward_fn(samples, queries, response_gt=None):
        return [walk_score(s, q) for s, q in zip(samples, queries)]

    def metric_fn(samples: List[str]) -> Dict[str, List[float]]:
        # the eval prompts in their fixed order: one per start node
        starts = list(range(1, n_nodes))
        return {"optimality": [walk_score(s, str(st)) for s, st in zip(samples, starts * 10)]}

    vocab = n_nodes + 2
    logit_mask = np.zeros((vocab, vocab), dtype=bool)
    logit_mask[:n_nodes, :n_nodes] = adj
    return reward_fn, metric_fn, [[i] for i in range(1, n_nodes)], logit_mask, dict(
        adj=adj, dists=dists, goal=goal, n_nodes=n_nodes, walk_length=walk_length)


def main(overrides: dict | None = None, device=None):
    """Train ``configs/ppo_randomwalks.yml`` with ``overrides``; returns the
    final stats. ``device=None`` is CUDA, ``"cpu"`` the plain versions."""
    import trlx_tpu_torch
    from trlx_tpu_torch.data.configs import TRLConfig

    config = TRLConfig.load_yaml(os.path.join(ROOT, "configs", "ppo_randomwalks.yml"))
    if overrides:
        config.update(**overrides)
    reward_fn, metric_fn, prompts, _, _ = make_task()
    trainer = trlx_tpu_torch.train(
        reward_fn=reward_fn, metric_fn=metric_fn, prompts=prompts, eval_prompts=prompts,
        config=config, device=device,
    )
    return trainer._final_stats


if __name__ == "__main__":
    main()
