"""The serving tier as a whole: ``InferenceServer`` in both packages with
the shared-prefix pool, chunked admission prefill (two chunks a pump) and
speculative decoding with the trie drafter all on, serving the same
shared-prefix traffic from the same f32 weights (greedy, as deterministic
requests are served).

Every request gets the same tokens and length, with logprobs and values
to 1e-4 (the tolerance of ``tests/test_torch_server.py``); the pool's and
the engine's sharing counters and the chunk plan are equal; after the
traffic every pool reference is released. The drafters' counters are not
compared here: while a budgeted admission is in flight, the reference's
engine credits the stale slot's emissions to the row being admitted (its
drafter history then differs; see
``test_torch_chunked_prefill.py::test_budgeted_pump_streams_only_the_rows_tokens``),
so the two accept different drafts with the same tokens;
``test_torch_spec_decode.py`` holds them equal without a chunk budget. The
port's server with the features on also serves what it serves with them
off.
"""

import numpy as np
import pytest

Q, R = 16, 8
TOL = 1e-4
ROLLOUT = {"engine": "continuous", "slots": 8, "admit_width": 4, "harvest_width": 4,
           "block_size": 4}
FEATURES = {"prefill_chunk": 4, "prefill_chunks_per_pump": 2,
            "spec_decode": {"enabled": True, "max_draft": 3, "drafter": "trie"}}


def _config(features=True):
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    cfg["train"].update(seq_length=Q, dtype="float32",
                        rollout=dict(ROLLOUT, **(FEATURES if features else {})))
    cfg["train"]["serving"] = {
        "prefix_cache_blocks": 16 if features else 0,
        "slo_classes": {"standard": {"queue_wait_budget_ms": 120000}},
    }
    cfg["method"]["gen_kwargs"].update(max_new_tokens=R, do_sample=False)
    return cfg


def _traffic(seed=0):
    """16 requests: 12 share one of two 8-token system prompts, each with
    its own 8-token turn (full length, so they pad alike); 4 take other
    lengths. Submitted in two waves, so the second reads what the first
    published."""
    rng = np.random.default_rng(seed)
    systems = rng.integers(1, 29, (2, Q // 2))
    shared = [list(systems[i % 2]) + list(rng.integers(1, 29, Q // 2)) for i in range(12)]
    other = [list(rng.integers(1, 29, int(rng.integers(2, Q)))) for _ in range(4)]
    prompts = [[int(t) for t in p] for p in shared[:6] + other[:2] + shared[6:] + other[2:]]
    return prompts[:8], prompts[8:]


@pytest.fixture(scope="module")
def served():
    import jax

    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu_torch.inference.server import InferenceServer as TServer
    from trlx_tpu_torch.models.convert import flax_to_torch

    jserver = JServer(TRLConfig.from_dict(_config()))
    captured = {}
    land = jserver._land_group

    def capture(group):
        for j, row in enumerate(group["rows"]):
            rid = jserver._row_to_req.get(row)
            if rid is not None:
                captured[rid] = {k: np.asarray(jax.device_get(group[k]))[j]
                                 for k in ("response_mask", "logprobs", "values")}
        land(group)

    jserver._land_group = capture
    params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
    tserver = TServer(_config(), params=params, device="cpu")
    results = {}
    for name, server in (("jax", jserver), ("port", tserver)):
        out = []
        for wave in _traffic():
            out += server.generate(wave)
        results[name] = out
    return jserver, tserver, results, captured, params


def test_servers_give_the_same_tokens(served):
    jserver, tserver, results, captured, _ = served
    got, want = results["port"], results["jax"]
    assert len(got) == len(want) == 16
    for rid, (g, w) in enumerate(zip(got, want)):
        n = int(captured[rid]["response_mask"].sum())
        assert g["tokens"] == w["tokens"] and g["length"] == w["length"] == n
        np.testing.assert_allclose(g["logprobs"], captured[rid]["logprobs"][:n], atol=TOL, rtol=0)
        np.testing.assert_allclose(g["values"], captured[rid]["values"][:n], atol=TOL, rtol=0)


def test_servers_share_and_chunk_alike(served):
    jserver, tserver, _, _, _ = served
    j, t = jserver.stats(), tserver.stats()
    keys = [k for k in j if k.startswith("prefix_pool/")] + [
        "engine/prefix_hit_rate", "engine/prefix_blocks_saved", "engine/prefill_chunks",
        "engine/prefill_cols_skipped", "engine/admitted", "engine/completed",
        "engine/released"]
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    assert t["prefix_pool/hits"] > 0 and t["engine/prefill_cols_skipped"] > 0
    assert tserver.engine.stats.spec_steps > 0 and tserver.engine.stats.spec_accepted > 0
    assert tserver.engine.stats.prefix_hit_blocks == jserver.engine.stats.prefix_hit_blocks > 0


def test_pool_references_all_released(served):
    _, tserver, _, _, _ = served
    pool = tserver.prefix_pool
    assert all(n.refcount == 0 for n in pool._nodes.values())
    assert len(pool._nodes) + pool.free_blocks == pool.pool_blocks
    assert not tserver._acquired and not tserver._published_by_row
    from trlx_tpu_torch.serving import TrieDrafter

    assert isinstance(tserver.engine.spec_drafter, TrieDrafter)
    assert tserver.engine.spec_drafter.pool is pool


def test_features_off_serve_the_same_tokens(served):
    from trlx_tpu_torch.inference.server import InferenceServer

    _, _, results, _, params = served
    plain = InferenceServer(_config(features=False), params=params, device="cpu")
    out = []
    for wave in _traffic():
        out += plain.generate(wave)
    assert [r["tokens"] for r in out] == [r["tokens"] for r in results["port"]]
    assert plain.stats()["engine/prefill_chunks"] == 0 and plain.prefix_pool is None
