"""The port's serving path against the JAX package's, end to end.

One module-scoped pair of servers on the test harness's tiny PPO config
(f32, greedy): the JAX server is built first on the conftest CPU mesh and
its params are carried across with ``models/convert.py``. Every request
must get exactly the same tokens and response length, with logprobs and
values to 1e-4. Then the port's copies of the scheduler and stream-router
units of ``tests/test_serving.py``, and the server-level streaming and
placeholder pins.
"""

import numpy as np
import pytest
import torch

from trlx_tpu_torch.serving import ServingConfig
from trlx_tpu_torch.serving.scheduler import (
    QoSScheduler,
    Request,
    TenantConfig,
    TokenBucket,
    tenant_metric_key,
)
from trlx_tpu_torch.serving.streaming import StreamRouter, TokenStream

ROLLOUT = {"slots": 8, "admit_width": 4, "harvest_width": 4, "block_size": 4}
TOL = 1e-4


def _config():
    from trlx_tpu.analysis import harness

    cfg = harness.tiny_config_dict("ppo")
    cfg["train"]["dtype"] = "float32"
    cfg["train"]["rollout"] = dict(ROLLOUT)
    cfg["train"]["serving"] = {
        "slo_classes": {"standard": {"queue_wait_budget_ms": 120000}},
    }
    cfg["method"]["gen_kwargs"]["do_sample"] = False
    return cfg


@pytest.fixture(scope="module")
def servers():
    import jax

    from trlx_tpu.data.configs import TRLConfig
    from trlx_tpu.inference.server import InferenceServer as JServer
    from trlx_tpu_torch.inference.server import InferenceServer as TServer
    from trlx_tpu_torch.models.convert import flax_to_torch

    jserver = JServer(TRLConfig.from_dict(_config()))
    # the JAX server keeps only tokens in its results: record each landed
    # group's logprobs/values per request before the server consumes it
    captured = {}
    land = jserver._land_group

    def capture(group):
        for j, row in enumerate(group["rows"]):
            rid = jserver._row_to_req.get(row)
            if rid is not None:
                captured[rid] = {
                    k: np.asarray(jax.device_get(group[k]))[j]
                    for k in ("tokens", "response_mask", "logprobs", "values")
                }
        land(group)

    jserver._land_group = capture
    params = flax_to_torch(jax.tree_util.tree_map(np.asarray, jserver.params))
    tserver = TServer(_config(), params=params, device="cpu")
    return jserver, captured, tserver


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [
        [int(x) for x in rng.integers(1, 30, int(rng.integers(1, 9)))]
        for _ in range(n)
    ]


def test_server_matches_jax_server(servers):
    jserver, captured, tserver = servers
    prompts = _prompts(10, 0)  # 10 rows into width-4 groups: placeholders too
    jres = jserver.wait(jserver.submit(prompts))
    tres = tserver.wait(tserver.submit(prompts))
    assert len(jres) == len(tres) == 10
    for jrid, trid in zip(sorted(jres), sorted(tres)):
        j, t, cap = jres[jrid], tres[trid], captured[jrid]
        n = int(cap["response_mask"].sum())
        assert t["tokens"] == j["tokens"] and t["length"] == j["length"] == n
        np.testing.assert_allclose(t["logprobs"], cap["logprobs"][:n], atol=TOL, rtol=0)
        np.testing.assert_allclose(t["values"], cap["values"][:n], atol=TOL, rtol=0)
    assert tserver.stats()["engine/released"] == 2.0


def test_streaming_first_token_before_harvest(servers):
    _, _, server = servers
    rid = server.submit(_prompts(1, 1), stream=True)[0]
    stream = server.stream(rid)
    first = next(stream)
    assert server.poll(rid) is None  # arrived mid-decode, before harvest
    streamed = [first] + list(stream)
    out = server.wait([rid])[rid]
    assert out["length"] >= 1 and streamed == out["tokens"]


def test_placeholder_padding_completes_and_releases(servers):
    _, _, server = servers
    before = server.engine.stats.released
    rids = server.submit(_prompts(3, 3))
    results = server.wait(rids)
    assert all(results[r]["length"] >= 1 for r in rids)
    assert server.engine.stats.released > before
    timing = results[rids[0]]["timing"]
    assert timing["ttft_ms"] <= timing["e2e_ms"]


def test_engine_drive_yields_the_served_tokens(servers):
    """The trainer-side loop (``drive``) over a fresh engine on the same
    model gives every row the tokens the server gave it (greedy)."""
    from trlx_tpu_torch.inference.engine import ContinuousBatchingEngine
    from trlx_tpu_torch.models.gpt2 import init_cache

    _, _, server = servers
    engine = ContinuousBatchingEngine(
        apply_fn=server.model,
        init_cache_fn=lambda b, cap, **kw: init_cache(server.model_config, b, cap, **kw),
        gen_config=server.gen_config, query_length=server.query_length,
        vocab_size=server.model_config.vocab_size, num_slots=8,
        admit_width=4, harvest_width=4, block_size=4, device="cpu",
    )
    engine.start_phase(seed=0)
    prompts = _prompts(8, 5)
    padded = [server._pad_prompt(p, i) for i, p in enumerate(prompts)]
    rows = engine.submit(np.stack([p[0] for p in padded]), np.stack([p[1] for p in padded]))
    got = {}
    for group in engine.drive(8):
        for j, row in enumerate(group["rows"]):
            n = int(group["response_mask"][j].sum())
            got[row] = group["tokens"][j, :n].tolist()
    served = server.generate(prompts)
    assert [got[r] for r in rows] == [s["tokens"] for s in served]
    assert engine.stats.completed == 8 and engine.stats.prefills == 2


def test_sampled_tokens_do_not_depend_on_admission_schedule(servers):
    """Per-row noise is seeded by (phase seed, row draw index, step): the
    same submissions served through a different slot pool and admission
    width — so other slots, groups and batch neighbours — sample the same
    tokens."""
    from trlx_tpu_torch.inference.server import InferenceServer

    _, _, server = servers
    params = server.model.state_dict()
    prompts = _prompts(9, 8)
    outs = []
    for rollout in (
        {"slots": 8, "admit_width": 4, "harvest_width": 4, "block_size": 4},
        {"slots": 3, "admit_width": 1, "harvest_width": 1, "block_size": 2},
    ):
        cfg = _config()
        cfg["train"]["rollout"] = rollout
        cfg["method"]["gen_kwargs"]["do_sample"] = True
        srv = InferenceServer(cfg, params=params, seed=11, device="cpu")
        outs.append([r["tokens"] for r in srv.generate(prompts)])
    assert outs[0] == outs[1]


def test_unported_features_raise():
    """``spec_decode`` under the fixed engine is refused with the
    reference's own ``ValueError``. The int8 shared-prefix pool, refused
    until the int8 KV cache was ported, now builds with its scales and
    serves (its parity with the reference is
    ``tests/test_torch_kv_int8.py``)."""
    from trlx_tpu_torch.inference import RolloutEngineConfig
    from trlx_tpu_torch.inference.kv_cache import init_shared_pool
    from trlx_tpu_torch.inference.server import InferenceServer

    with pytest.raises(ValueError, match="spec_decode"):
        RolloutEngineConfig.from_dict({"engine": "fixed", "spec_decode": {"enabled": True}})
    pool = init_shared_pool(4, 4, 2, 16, torch.float32, kv_cache_dtype="int8")
    assert pool["shared_k"].dtype == torch.int8 and pool["shared_v_scale"].shape == (17, 2, 1)
    cfg = _config()
    cfg["model"]["model_arch"]["kv_cache_dtype"] = "int8"
    cfg["train"]["serving"] = {"prefix_cache_blocks": 4}
    server = InferenceServer(cfg, device="cpu")
    layer = server.engine.init_state().cache[0]
    assert layer["k"].dtype == torch.int8 and layer["shared_k_scale"].dtype == torch.bfloat16


def test_serving_features_are_accepted_and_run():
    """Chunked prefill, speculative decoding and the shared-prefix pool
    construct and serve (their parity with the reference is
    ``tests/test_torch_serving_tier.py``)."""
    from trlx_tpu_torch.inference import RolloutEngineConfig
    from trlx_tpu_torch.inference.server import InferenceServer

    rollout = RolloutEngineConfig.from_dict(
        {"engine": "continuous", "prefill_chunk": 128, "spec_decode": {"enabled": True}}
    )
    assert rollout.prefill_chunk == 128 and rollout.spec_decode.enabled
    cfg = _config()
    cfg["train"]["rollout"] = dict(ROLLOUT, engine="continuous", prefill_chunk=4,
                                   spec_decode={"enabled": True, "max_draft": 2})
    server = InferenceServer(cfg, device="cpu", serving={"prefix_cache_blocks": 8})
    prompt = list(range(1, 9))
    # the second wave reads the blocks the first published
    results = server.generate([prompt] * 2) + server.generate([prompt] * 4)
    assert all(r["length"] >= 1 for r in results)
    stats = server.stats()
    assert stats["prefix_pool/hits"] > 0 and stats["engine/prefill_chunks"] > 0
    assert server.engine.stats.spec_steps > 0 and server.engine.spec_max_draft == 2


def test_entry_point_refuses_missing_cuda():
    """``device=None`` means CUDA; without it the server raises instead
    of falling back to the CPU."""
    from trlx_tpu_torch.inference.server import InferenceServer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(_config())


# --------------- scheduler / stream-router units (ported) --------------- #


def _req(rid, tenant="t", prio=0, cost=0.0, deadline=None, at=1.0):
    return Request(
        request_id=rid, tenant=tenant, prompt_ids=None, prompt_mask=None,
        priority=prio, cost=cost, deadline=deadline, submitted_at=at,
    )


def test_token_bucket_refill_and_exhaustion():
    b = TokenBucket(rate=10.0, burst=20.0)
    assert b.try_charge(20.0, now=0.0)
    assert not b.try_charge(1.0, now=0.0)
    assert not b.try_charge(11.0, now=1.0)
    assert b.try_charge(10.0, now=1.0)
    assert b.try_charge(20.0, now=100.0)


def test_scheduler_priority_admission_order():
    s = QoSScheduler(clock=lambda: 1.0)
    low = [s.submit(_req(i, "low", prio=0)) for i in range(3)]
    high = s.submit(_req(9, "high", prio=5))
    batch = s.next_batch(2, now=1.0)
    assert batch[0] is high
    assert batch[1] is low[0]


def test_scheduler_aging_prevents_starvation():
    s = QoSScheduler(aging_half_ms=1000.0, clock=lambda: 11.0)
    old_low = s.submit(_req(1, "low", prio=0, at=1.0))
    fresh_high = s.submit(_req(2, "high", prio=5, at=11.0))
    assert s.next_batch(1, now=11.0) == [old_low]
    assert s.next_batch(1, now=11.0) == [fresh_high]


def test_scheduler_quota_exhaustion_and_refill():
    s = QoSScheduler(
        tenants={"metered": TenantConfig("metered", rate=10.0, burst=10.0)},
        clock=lambda: 0.0,
    )
    reqs = [s.submit(_req(i, "metered", cost=10.0, at=0.0)) for i in range(3)]
    assert s.next_batch(3, now=0.0) == [reqs[0]]
    assert s.throttled_rounds >= 1
    assert s.next_batch(3, now=0.5) == []
    assert s.next_batch(3, now=1.0) == [reqs[1]]
    assert s.next_batch(3, now=2.0) == [reqs[2]]
    assert not s.has_work()


def test_scheduler_quota_never_bypassed_by_aging():
    s = QoSScheduler(
        tenants={"metered": TenantConfig("metered", rate=0.001, burst=1.0)},
        aging_half_ms=1.0,
        clock=lambda: 1000.0,
    )
    s.submit(_req(0, "metered", cost=1.0, at=0.0))
    s.submit(_req(1, "metered", cost=1.0, at=0.0))
    s.submit(_req(2, "free", prio=0, at=1000.0))
    batch = s.next_batch(3, now=1000.0)
    assert [r.request_id for r in batch] == [0, 2]


def test_scheduler_unadmittable_cost_refused_at_submit():
    s = QoSScheduler(
        tenants={"metered": TenantConfig("metered", rate=10.0, burst=10.0)},
        clock=lambda: 0.0,
    )
    with pytest.raises(ValueError, match="could never be admitted"):
        s.submit(_req(1, "metered", cost=10.5))
    assert not s.has_work()
    s.submit(_req(2, "metered", cost=10.0))
    assert s.next_batch(1, now=0.0) != []


def test_scheduler_deadline_ordering():
    s = QoSScheduler(clock=lambda: 1.0)
    s.submit(_req(1, at=1.0))
    s.submit(_req(2, deadline=50.0, at=1.0))
    s.submit(_req(3, deadline=5.0, at=1.0))
    assert [r.request_id for r in s.next_batch(3, now=1.0)] == [3, 2, 1]


def test_scheduler_slo_pressure_reads_histograms():
    from trlx_tpu.telemetry.metrics import MetricsRegistry

    registry = MetricsRegistry(enabled=True)
    hist = registry.histogram(tenant_metric_key("serve/queue_wait_ms", "pressured"))
    for _ in range(10):
        hist.observe(1900.0)
    s = QoSScheduler(clock=lambda: 1.0, registry=registry)
    quiet = s.submit(_req(1, "quiet", at=1.0))
    pressured = s.submit(_req(2, "pressured", at=1.0))
    batch = s.next_batch(2, now=1.0)
    assert batch[0] is pressured and batch[1] is quiet
    key = tenant_metric_key("serve/slo_queue_wait_ratio", "pressured")
    assert 0.9 < s.slo_ratio_rows()[key] < 1.0


def test_zero_rate_finite_burst_tenant_refused():
    with pytest.raises(ValueError, match="never refill"):
        TenantConfig.from_dict("paused", {"rate": 0.0, "burst": 100.0})
    TenantConfig.from_dict("free", {"priority": 1})


def test_serving_config_validation():
    with pytest.raises(ValueError, match="Unknown train.serving"):
        ServingConfig.from_dict({"tenant": {}})
    with pytest.raises(ValueError, match="serving.tenants"):
        TenantConfig.from_dict("x", {"priorty": 1})
    with pytest.raises(ValueError, match="slo_class"):
        QoSScheduler().submit(
            Request(request_id=1, tenant="t", prompt_ids=None,
                    prompt_mask=None, slo_class="platinum")
        )


def test_token_stream_bounded_overflow_and_iter():
    s = TokenStream(1, maxlen=2)
    for t in (10, 11, 12):
        s.push(t)
    assert s.overflows == 1 and s.emitted == 3
    assert s.drain() == [11, 12]

    s2 = TokenStream(2, maxlen=8)
    pumped = []

    def pump():
        if pumped:
            s2.close()
        else:
            s2.push(7)
            pumped.append(1)

    s2._pump = pump
    assert next(s2) == 7
    with pytest.raises(StopIteration):
        next(s2)


def test_stream_router_routes_live_rows_only():
    r = StreamRouter(maxlen=8)
    a = TokenStream(0, maxlen=8)
    r.attach(0, a)
    r.attach(3, TokenStream(3, maxlen=8))
    r.on_tokens({0: 5, 3: 6, 7: 9})
    assert a.drain() == [5]
    assert r.get(3).drain() == [6]
    r.close(0)
    r.on_tokens({0: 8})
    assert a.drain() == []
    assert r.active == 1
