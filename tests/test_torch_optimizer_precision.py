"""bf16 Adam moments with stochastic rounding (``train.adam_moment_dtype:
"bfloat16"``): the port's ``stochastic_round`` and ``LowPrecisionAdamW``
(``trlx_tpu_torch/trainer/common.py``) against the JAX package's
``stochastic_round`` and ``make_optimizer`` (``trlx_tpu/trainer/common.py``).

- ``stochastic_round`` fed ``jax.random.bits`` is bit-equal to the JAX one,
  at the edges too (-0.0, negatives, max finite rounding up to inf, a carry
  into the exponent, inf, nan); f32 passes through; other dtypes raise.
- The rounding is unbiased and accumulates a sub-resolution EMA, as
  ``tests/test_optimizer_precision.py`` asks of the JAX one.
- Five steps under the JAX key lineage's noise (``fold_in(key(0x5EED,
  rbg), count)`` split 2n ways, mu first) match the JAX optimizer: params
  to 1e-6 absolute, the stored moments bit for bit (this CPU: every
  element of 4100, 4100, 2600 and 2600 per moment), with and without the
  clip, with a frozen leaf, and with the update's ranges cutting through
  the parameters.
- 300 noisy-regression steps land within 2 % of the JAX f32-moment run.
- The refusals, the checkpoint round trip and the other layout's
  ``ValueError``, a preempted run's resume and the streamed phase, each
  ``torch.equal`` to its uninterrupted or serial twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_ppo_phase import config as phase_config
from _torch_ppo_phase import port_trainer
from trlx_tpu.data.configs import TrainConfig as JTrainConfig
from trlx_tpu.trainer.common import ScaleByAdamLPState
from trlx_tpu.trainer.common import make_optimizer as jmake_optimizer
from trlx_tpu.trainer.common import stochastic_round as jstochastic_round
from trlx_tpu_torch.data.configs import TrainConfig as TTrainConfig
from trlx_tpu_torch.trainer import common as tcommon

F32_MAX = float(np.finfo(np.float32).max)
EDGES = np.array([
    0.0, -0.0, 1.0, -1.0, 1.0 + 2 ** -9, -3.7e-4, 0.123456, 5.0e5, -1.0 - 2 ** -10,
    F32_MAX, -F32_MAX, 1.9999999,  # 1.9999999: a carry into the exponent
    np.float32(2 ** -126), np.float32(1e-45), np.inf, -np.inf, np.nan,
], dtype=np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int16)


def _jax_bits(key, shape) -> np.ndarray:
    return np.asarray(jax.random.bits(key, shape, jnp.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_round_is_the_jax_rounding_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    x = np.concatenate([EDGES, (rng.normal(size=4096) * 10.0 ** rng.integers(
        -30, 30, size=4096)).astype(np.float32)])
    key = jax.random.key(seed)
    noise = _jax_bits(key, x.shape)  # the JAX function's own draw; top bits set
    assert (noise >> 16).any()
    want = np.asarray(jstochastic_round(jnp.asarray(x), key, jnp.bfloat16).astype(jnp.float32))
    got = tcommon.stochastic_round(torch.from_numpy(x), torch.bfloat16,
                                   noise=torch.from_numpy(noise.view(np.int32).copy()))
    assert got.dtype == torch.bfloat16
    got32 = got.float().numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got32), nan)
    np.testing.assert_array_equal(got32[~nan].view(np.int32), want[~nan].view(np.int32))
    # max finite rounds up to inf under the largest noise, as in JAX
    top = tcommon.stochastic_round(torch.tensor([F32_MAX]), torch.bfloat16,
                                   noise=torch.tensor([0xFFFF], dtype=torch.int32))
    assert torch.isinf(top).all()


def test_stochastic_round_passes_f32_and_refuses_other_dtypes():
    x = torch.randn(8)
    assert tcommon.stochastic_round(x, torch.float32) is x
    with pytest.raises(ValueError, match="supports bfloat16"):
        jstochastic_round(jnp.asarray(x.numpy()), jax.random.key(0), jnp.float16)
    with pytest.raises(ValueError, match="supports bfloat16"):
        tcommon.stochastic_round(x, torch.float16)


def test_stochastic_round_is_unbiased():
    x = torch.tensor([1.0 + 2 ** -9, -3.7e-4, 0.123456, 5.0e5, -1.0 - 2 ** -10])
    gen = torch.Generator().manual_seed(0)
    rounded = tcommon.stochastic_round(x.expand(4096, -1).contiguous(), torch.bfloat16,
                                       generator=gen).float()
    mean = rounded.mean(0).double().numpy()
    ulp = np.abs(x.double().numpy()) * 2.0 ** -8
    assert np.all(np.abs(mean - x.double().numpy()) < 0.15 * ulp + 1e-12), (mean, x)


def test_stochastic_round_accumulates_subresolution_ema():
    """nu = b2 nu + (1 - b2) g^2 at b2 = 0.999: round-to-nearest bf16
    stalls below the f32 EMA; stochastic rounding tracks it."""
    b2, g2, n = 0.999, 1.0, 2000
    nu_f32, nu_rtn = 0.0, torch.zeros((), dtype=torch.bfloat16)
    nu_sr = torch.zeros(256, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(7)
    for _ in range(n):
        nu_f32 = b2 * nu_f32 + (1 - b2) * g2
        nu_sr = tcommon.stochastic_round(b2 * nu_sr.float() + (1 - b2) * g2, torch.bfloat16,
                                         generator=gen)
        nu_rtn = (b2 * nu_rtn.float() + (1 - b2) * g2).to(torch.bfloat16)
    assert abs(nu_sr.float().mean().item() - nu_f32) < 0.05 * nu_f32
    assert nu_rtn.item() < 0.9 * nu_f32


SHAPES = {"w": (64, 40), "b": (40,), "e": (50, 30)}
STEPS, TOTAL = 5, 8
KW = dict(lr_init=1e-2, lr_target=2e-3, opt_betas=(0.9, 0.95), opt_eps=1e-8,
          weight_decay=0.01, grad_clip=1.0, adam_moment_dtype="bfloat16")


def jax_noise(shapes):
    """``n -> (mu bits, nu bits)`` of the JAX optimizer's update ``n``: its
    key lineage split 2 x leaves ways, each leaf's bits in leaf order."""
    def noise(count):
        base = jax.random.fold_in(jax.random.key(0x5EED, impl="rbg"), count)
        keys = jax.random.split(base, 2 * len(shapes))
        flat = [_jax_bits(k, s).reshape(-1).view(np.int32) for k, s in zip(
            keys, list(shapes) * 2)]
        half = len(shapes)
        return (torch.from_numpy(np.concatenate(flat[:half])),
                torch.from_numpy(np.concatenate(flat[half:])))
    return noise


@pytest.mark.parametrize("grad_scale,clipped,frozen,chunk", [
    (0.01, False, (), None), (3.0, True, (), None), (0.01, False, ("e",), None),
    (3.0, True, ("e",), 777)],
    ids=["unclipped", "clipped", "frozen_leaf", "ranges_across_parameters"])
def test_five_steps_match_the_jax_optimizer(grad_scale, clipped, frozen, chunk, monkeypatch):
    if chunk is not None:  # the update's ranges cut through the parameters
        monkeypatch.setattr(tcommon, "CHUNK", chunk)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    names = sorted(SHAPES)  # the JAX dict's leaf order
    trainable = [k for k in names if k not in frozen]

    mask = {k: k not in frozen for k in names}
    tx = jmake_optimizer(JTrainConfig(**KW), TOTAL, trainable_mask=mask if frozen else None)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    jnorms = []
    for g in grads:  # a frozen leaf's gradient is stopped in the JAX loss
        g = {k: jnp.zeros(SHAPES[k]) if k in frozen else jnp.asarray(v) for k, v in g.items()}
        jnorms.append(float(optax.global_norm(g)))
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    lp = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda s: isinstance(s, ScaleByAdamLPState))
        if isinstance(s, ScaleByAdamLPState)]
    assert len(lp) == 1 and int(lp[0].count) == STEPS

    tparams = {k: torch.nn.Parameter(torch.from_numpy(params[k].copy()),
                                     requires_grad=k not in frozen) for k in names}
    opt = tcommon.make_optimizer(TTrainConfig(**KW), TOTAL, tparams.values())
    assert isinstance(opt, tcommon.LowPrecisionAdamW)
    assert len(opt.chunks) == (1 if chunk is None else -(-opt.mu.numel() // chunk))
    opt.noise_fn = jax_noise([SHAPES[k] for k in trainable])
    for step, g in enumerate(grads):
        for k in trainable:
            tparams[k].grad = torch.from_numpy(g[k].copy())
        norm = opt.step().item()
        np.testing.assert_allclose(norm, jnorms[step], rtol=1e-5)
        assert (norm >= 1.0) == clipped
    assert opt.count == STEPS
    for k in names:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=0, err_msg=k)
    if frozen:
        assert np.array_equal(tparams["e"].detach().numpy(), params["e"])
    for name, tree, mine in (("mu", lp[0].mu, opt.mu), ("nu", lp[0].nu, opt.nu)):
        want = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree_util.tree_leaves(tree)])
        assert mine.dtype == torch.bfloat16 and mine.numel() == want.size
        got_bits, want_bits = _bits(mine.view(torch.int16).numpy()), _bits(want)
        equal = int((got_bits == want_bits).sum())
        assert equal >= 0.999 * want.size, (name, equal, want.size)
        assert np.abs(got_bits.astype(np.int32) - want_bits.astype(np.int32)).max() <= 1, name


def test_300_steps_stay_within_two_percent_of_f32_moments():
    """Noisy linear regression (numpy seed): the port's bf16 moments under
    its own generator land within 2 % of the JAX package's f32 moments."""
    rng = np.random.default_rng(3)
    w_true = rng.normal(size=16).astype(np.float32)
    xs = rng.normal(size=(300, 32, 16)).astype(np.float32)
    ys = (xs @ w_true + 0.01 * rng.normal(size=(300, 32))).astype(np.float32)
    cfg = dict(lr_init=1e-2, lr_target=1e-2, opt_betas=(0.9, 0.999))

    tx = jmake_optimizer(JTrainConfig(**cfg), total_steps=300)

    @jax.jit
    def jstep(params, opt_state, x, y):
        def loss_fn(p):
            return jnp.mean((x @ p["w"] + p["b"] - y) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    jparams = {"w": jnp.zeros(16), "b": jnp.zeros(())}
    jstate = tx.init(jparams)
    for x, y in zip(xs, ys):
        jparams, jstate, jloss = jstep(jparams, jstate, x, y)
    w32, loss32 = np.asarray(jparams["w"]), float(jloss)

    w = torch.nn.Parameter(torch.zeros(16))
    b = torch.nn.Parameter(torch.zeros(()))
    opt = tcommon.make_optimizer(TTrainConfig(**cfg, adam_moment_dtype="bfloat16"), 300, [w, b])
    for x, y in zip(xs, ys):
        opt.zero_grad()
        loss = ((torch.from_numpy(x) @ w + b - torch.from_numpy(y)) ** 2).mean()
        loss.backward()
        opt.step()
    wbf = w.detach().numpy()
    assert np.linalg.norm(wbf - w32) < 0.02 * max(np.linalg.norm(w32), 1.0)
    assert loss.item() < 2.0 * loss32 + 1e-3


def test_bf16_typo_raises_the_jax_message():
    with pytest.raises(ValueError) as jerr:
        jmake_optimizer(JTrainConfig(adam_moment_dtype="bf16"), 10)
    with pytest.raises(ValueError) as terr:
        tcommon.make_optimizer(TTrainConfig(adam_moment_dtype="bf16"), 10,
                               [torch.nn.Parameter(torch.zeros(2))])
    assert str(terr.value) == str(jerr.value)


def _bf16_config(tmp, **train):
    return phase_config(tmp, train={"adam_moment_dtype": "bfloat16", **train})


def _opt_tensors(trainer) -> dict:
    state = trainer.opt.state_dict()
    return {"mu": state["mu"], "nu": state["nu"],
            **{n: p for n, p in trainer.model.state_dict().items()}}


def test_checkpoint_round_trip_and_the_other_layout(tmp_path):
    """An async save of a bf16-moment trainer loads ``torch.equal``; a
    trainer of the other ``adam_moment_dtype`` refuses it (and the
    converse) with the actionable ``ValueError``."""
    trainer = port_trainer(_bf16_config(tmp_path / "a", async_checkpoint=True))
    trainer.learn()
    assert trainer.opt.count == 4 and trainer.opt.mu.dtype == torch.bfloat16
    assert trainer.opt.mu.numel() == sum(p.numel() for p in trainer.opt.params)
    directory = str(tmp_path / "a")
    fresh = port_trainer(_bf16_config(tmp_path / "b"))
    fresh.load(directory)
    want, got = _opt_tensors(trainer), _opt_tensors(fresh)
    assert fresh.opt.count == 4 and set(got) == set(want)
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    f32 = port_trainer(phase_config(tmp_path / "c"))
    with pytest.raises(ValueError, match="adam_moment_dtype"):
        f32.load(directory)
    f32.save()
    with pytest.raises(ValueError, match="adam_moment_dtype"):
        fresh.load(str(tmp_path / "c"))


def test_update_resumes_bit_for_bit_without_rng_state(tmp_path):
    """Four updates against two, a save and load into new parameters, then
    two more: the rounding noise is a function of the count alone."""
    from trlx_tpu_torch.utils.checkpoint import CheckpointWriter, load_checkpoint

    rng = np.random.default_rng(1)
    init = [rng.normal(size=s).astype(np.float32) for s in ((7, 5), (5,))]
    grads = [[rng.normal(size=a.shape).astype(np.float32) for a in init] for _ in range(4)]
    cfg = TTrainConfig(adam_moment_dtype="bfloat16", lr_init=1e-2, lr_target=1e-3)

    def make():
        params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        return params, tcommon.make_optimizer(cfg, 4, params)

    def run(params, opt, steps):
        for g in steps:
            for p, x in zip(params, g):
                p.grad = torch.from_numpy(x.copy())
            opt.step()

    params, opt = make()
    run(params, opt, grads)
    half, hopt = make()
    run(half, hopt, grads[:2])
    CheckpointWriter().save(str(tmp_path), {"p": [p.detach() for p in half],
                                            "opt": hopt.state_dict()}, 2, async_save=True)
    state = load_checkpoint(str(tmp_path), device="cpu")
    resumed, ropt = make()
    with torch.no_grad():
        for p, q in zip(resumed, state["p"]):
            p.copy_(q)
    ropt.load_state_dict(state["opt"])
    run(resumed, ropt, grads[2:])
    for p, q in zip(params, resumed):
        assert torch.equal(p, q)
    assert torch.equal(opt.mu, ropt.mu) and torch.equal(opt.nu, ropt.nu) and ropt.count == 4


def test_preempted_bf16_run_resumes_bit_for_bit(tmp_path):
    """A run preempted at its first pass boundary and resumed by the
    supervisor (async write) ends ``torch.equal`` to the uninterrupted run,
    moments included."""
    import trlx_tpu_torch
    from _torch_ppo_phase import prompts, reward_fn
    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.resilience import chaos

    finals = {}
    for name, train in (("plain", {}), ("resumed", {
            "async_checkpoint": True, "resilience": {
                "enabled": True, "chaos": [{"site": "preempt", "mode": "preempt", "phase": 0}]}})):
        cfg = _bf16_config(tmp_path / name, epochs=2, total_steps=8, **train)
        try:
            finals[name] = trlx_tpu_torch.train(
                reward_fn=reward_fn, prompts=prompts(), config=TRLConfig.from_dict(cfg),
                device="cpu")
        finally:
            chaos.clear()
    want, got = _opt_tensors(finals["plain"]), _opt_tensors(finals["resumed"])
    assert finals["resumed"].step == finals["plain"].step == 8
    for key, t in want.items():
        assert torch.equal(got[key], t), key
    assert torch.equal(finals["plain"].generator.get_state(),
                       finals["resumed"].generator.get_state())


def test_streamed_phase_with_bf16_moments_matches_the_serial_plan(tmp_path):
    """``learn()``'s streamed phases (the behaviour snapshot, epoch-1
    updates while collecting) against every phase held to its end."""
    finals = {}
    for overlap in (None, False):
        trainer = port_trainer(_bf16_config(tmp_path / str(overlap), epochs=2, total_steps=8))
        begin = trainer.begin_streamed_phase
        trainer.begin_streamed_phase = (
            lambda seed=0, num_rollouts=None, begin=begin, overlap=overlap:
            begin(seed=seed, num_rollouts=num_rollouts, overlap=overlap))
        trainer.learn()
        assert trainer.step == 8
        finals[overlap] = trainer
    want, got = _opt_tensors(finals[False]), _opt_tensors(finals[None])
    for key, t in want.items():
        assert torch.equal(got[key], t), key
