"""The port's optimizer (global-norm clip, then AdamW under the cosine
schedule) against the JAX package's ``make_optimizer`` on the same
gradients.

A few steps from the same f32 parameters with the same gradient sequence
(numpy seed), ``lr_init != lr_target`` so the cosine schedule moves, once
with gradients under the clip and once with every step clipped. Tolerance:
parameters to 1e-6 absolute and the reported norm to 1e-5 relative —
``torch.optim.AdamW`` and ``optax.adamw`` compute the same update term by
term and differ only in rounding order (f32).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trlx_tpu.data.configs import TrainConfig as JTrainConfig
from trlx_tpu.trainer.common import make_optimizer as jmake_optimizer
from trlx_tpu_torch.data.configs import TrainConfig as TTrainConfig
from trlx_tpu_torch.trainer import common as tcommon

SHAPES = {"w": (6, 5), "b": (5,), "e": (11, 3)}
STEPS, TOTAL = 5, 8


@pytest.mark.parametrize("grad_scale,clipped", [(0.01, False), (3.0, True)])
def test_steps_match_make_optimizer(grad_scale, clipped):
    kw = dict(lr_init=1e-2, lr_target=2e-3, opt_betas=(0.9, 0.95), opt_eps=1e-8,
              weight_decay=0.01, grad_clip=1.0)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * grad_scale).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]

    tx = jmake_optimizer(JTrainConfig(**kw), TOTAL)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    jnorms = []
    for g in grads:
        g = {k: jnp.asarray(v) for k, v in g.items()}
        jnorms.append(float(optax.global_norm(g)))
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tcommon.make_optimizer(TTrainConfig(**kw), TOTAL, tparams.values())
    for step, g in enumerate(grads):
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step().item()
        np.testing.assert_allclose(norm, jnorms[step], rtol=1e-5)
        assert (norm >= 1.0) == clipped
    assert opt.count == STEPS
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_cosine_schedule_matches_optax():
    sched = optax.cosine_decay_schedule(3e-4, 10, alpha=0.1)
    for count in (0, 1, 5, 9, 10, 25):
        np.testing.assert_allclose(
            tcommon.cosine_lr(count, 3e-4, 3e-5, 10), float(sched(count)), rtol=1e-6
        )


def test_freeze_layers_trains_the_top_blocks_and_heads():
    from trlx_tpu_torch.models.gpt2 import GPT2Config
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    model = CausalLMWithValueHead(
        GPT2Config(vocab_size=8, n_positions=8, n_embd=8, n_layer=3, n_head=2), device="cpu"
    )
    tcommon.freeze_layers(model, 1, 3)
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert all(n.startswith(("transformer.h.2.", "transformer.ln_f", "v_head")) for n in trainable)
    assert "transformer.h.2.attn.c_attn.weight" in trainable and "v_head.fc2.bias" in trainable
    tcommon.freeze_layers(model, -1, 3)
    assert all(p.requires_grad for p in model.parameters())
