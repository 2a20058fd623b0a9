"""The port's rollout buffer, update plans and prompt pipeline against the
JAX package's: the same seeds must give the same schedules and batches,
index for index (all host numpy draws, so equality is exact).

- ``make_stream_plan``: epoch-1 arrival blocks and the residual global
  permutations;
- ``PPORolloutBuffer.minibatch_order``: the rows of the JAX buffer's
  ``stacked_minibatches`` (its fused pass) and of its ``create_loader``
  (its stepwise pass), the one minibatch-major order the port runs;
- ``PromptPipeline``: left padding and truncation, the decoded prompt
  text, and ``create_loader``'s shuffled, tail-filled batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.data.ppo_types import PPORolloutBatch as JBatch
from trlx_tpu.pipeline import ppo_buffer as jbuf
from trlx_tpu.pipeline.prompt_pipeline import PromptPipeline as JPipeline
from trlx_tpu_torch.data.ppo_types import PPORolloutBatch as TBatch
from trlx_tpu_torch.pipeline import ppo_buffer as tbuf
from trlx_tpu_torch.pipeline.prompt_pipeline import PromptPipeline as TPipeline

FIELDS = ("query_tokens", "query_mask", "response_tokens", "response_mask",
          "logprobs", "values", "rewards")


def _chunks(n_chunks, rows):
    """Rollout chunks whose query_tokens[:, 0] is the global row id."""
    out = []
    for c in range(n_chunks):
        ids = np.arange(c * rows, (c + 1) * rows, dtype=np.int32)
        arrays = {k: np.zeros((rows, 3), np.float32) for k in FIELDS}
        arrays["query_tokens"] = np.stack([ids, ids, ids], 1)
        out.append(arrays)
    return out


@pytest.mark.parametrize("total,bs,epochs,seed", [(24, 8, 3, 0), (20, 4, 2, 7), (16, 16, 1, 3)])
def test_stream_plan_matches_jax(total, bs, epochs, seed):
    jp = jbuf.make_stream_plan(total, bs, epochs, seed)
    tp = tbuf.make_stream_plan(total, bs, epochs, seed)
    np.testing.assert_array_equal(tp.epoch1, jp.epoch1)
    np.testing.assert_array_equal(tp.residual, jp.residual)
    assert (tp.n_minibatches, tp.n_updates) == (jp.n_minibatches, jp.n_updates)
    np.testing.assert_array_equal(tp.updates(), np.concatenate([jp.epoch1, jp.residual]))


@pytest.mark.parametrize("n_minibatches", [None, 2])
def test_minibatch_orders_match_jax(n_minibatches):
    jb, tb = jbuf.PPORolloutBuffer(), tbuf.PPORolloutBuffer()
    for arrays in _chunks(3, 6):  # 18 rows: a non-dividing tail for bs 4
        jb.push(JBatch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        tb.push(TBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()}))
    assert len(tb) == len(jb) == 18
    stacked = jb.stacked_minibatches(4, shuffle=True, seed=5, repeat=2,
                                     n_minibatches=n_minibatches)
    order = tb.minibatch_order(4, seed=5, repeat=2, n_minibatches=n_minibatches)
    np.testing.assert_array_equal(order, np.asarray(stacked.query_tokens)[..., 0])
    gathered = tb.gather(order)
    np.testing.assert_array_equal(gathered.query_tokens.numpy(), np.asarray(stacked.query_tokens))
    jrows = [np.asarray(mb.query_tokens)[:, 0] for mb in jb.create_loader(4, shuffle=True, seed=9)]
    np.testing.assert_array_equal(tb.minibatch_order(4, seed=9), np.stack(jrows))
    tb.clear_history()
    assert len(tb) == 0


def test_prompt_pipeline_matches_jax():
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(1, 90, int(rng.integers(1, 12)))] for _ in range(11)]
    gt = [f"gt{i}" for i in range(11)]
    jp, tp = JPipeline(prompts, 8, response_gt=gt), TPipeline(prompts, 8, response_gt=gt)
    np.testing.assert_array_equal(tp.input_ids, jp.input_ids)
    np.testing.assert_array_equal(tp.attention_mask, jp.attention_mask)
    assert tp.prompts_text == jp.prompts_text
    assert (tp.min_prompt_tokens, tp.max_prompt_tokens) == (jp.min_prompt_tokens, jp.max_prompt_tokens)
    for kw in (dict(shuffle=True, seed=3, drop_last=False), dict(shuffle=False, drop_last=True)):
        jbatches = list(jp.create_loader(4, **kw))
        tbatches = list(tp.create_loader(4, **kw))
        assert len(tbatches) == len(jbatches)
        for (tbatch, tmeta), (jbatch, jmeta) in zip(tbatches, jbatches):
            np.testing.assert_array_equal(tbatch.input_ids.numpy(), np.asarray(jbatch.input_ids))
            np.testing.assert_array_equal(tbatch.attention_mask.numpy(),
                                          np.asarray(jbatch.attention_mask))
            assert tmeta == jmeta
