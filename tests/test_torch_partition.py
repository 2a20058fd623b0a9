"""The port's partition specs (``trlx_tpu_torch/parallel/partition.py``)
against the JAX package's ``make_partition_specs``.

For the ``gpt2``, ``gptj``, ``gpt_neox``, ``gpt_neo``, ``gpt2_moe`` and
``t5`` policies (value head included) at a small width (hidden 128, so
that fsdp's ``min_shard_size`` of 2**14 elements is met by the
projections and missed by the norms and biases), the JAX parameter tree
comes from ``jax.eval_shape`` (nothing compiled or allocated) and its
specs from the JAX function on meshes of the suite's 8 virtual devices:
``{fsdp: 2}``, ``{tp: 2}``, ``{fsdp: 2, tp: 4}`` and ``{dp: 2, fsdp: 2,
tp: 2}`` (``gpt2_moe`` also with ``ep: 2``). Held, entry by entry:

- the port's function on the same paths, shapes and mesh sizes gives the
  JAX specs exactly;
- the port's module, built on the ``meta`` device, has the JAX tree's
  parameters (``models/convert.py``'s name map, a ``Linear`` weight the
  transposed kernel) and ``module_specs`` gives each the JAX spec, reversed
  for a transposed kernel;
- both ``PartitionRuleError`` cases raise in both packages on the same
  rule and tree, with the same message;
- ``configs/ppo_neox20b.yml``'s mesh (``fsdp: 8, tp: 4``) shards every
  parameter of 4M elements or more of the 20B policy, as the JAX package's
  ``tests/test_neox20b_sharding.py`` holds for its own mesh;
- a ``ShardedModule`` at world 1 holds every parameter whole, and
  ``tp_index`` takes each tp rank's slice of each fused segment.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu_torch.models.convert import flax_paths
from trlx_tpu_torch.models.registry import get_model_family as port_family
from trlx_tpu_torch.parallel.mesh import mesh_sizes
from trlx_tpu_torch.parallel.partition import (
    PartitionRuleError,
    make_partition_specs,
    module_specs,
    tp_index,
    validate_rules,
)

ARCHS = {
    "gpt2": {"vocab_size": 64, "n_positions": 32, "n_embd": 128, "n_layer": 2, "n_head": 4},
    "gptj": {"vocab_size": 64, "n_positions": 32, "n_embd": 128, "n_layer": 2, "n_head": 4,
             "rotary_dim": 16},
    "gpt_neox": {"vocab_size": 64, "max_position_embeddings": 32, "hidden_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 4},
    "gpt_neo": {"vocab_size": 64, "max_position_embeddings": 32, "hidden_size": 128,
                "num_layers": 2, "num_heads": 4, "attention_layers": ["global", "local"]},
    "gpt2_moe": {"vocab_size": 64, "n_positions": 32, "n_embd": 128, "n_layer": 2,
                 "n_head": 4, "n_experts": 4, "moe_every": 2},
    "t5": {"vocab_size": 64, "d_model": 128, "d_kv": 32, "d_ff": 256, "num_layers": 2,
           "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 8,
           "relative_attention_max_distance": 16, "feed_forward_proj": "gated-gelu",
           "tie_word_embeddings": False},
}
MESHES = [{"dp": -1, "fsdp": 2}, {"dp": -1, "tp": 2}, {"dp": -1, "fsdp": 2, "tp": 4},
          {"dp": 2, "fsdp": 2, "tp": 2}]
EP_MESHES = [{"dp": -1, "fsdp": 2, "ep": 2}, {"dp": -1, "tp": 2, "ep": 2}]
CASES = [(f, i) for f in ARCHS for i in range(len(MESHES))] + [
    ("gpt2_moe", len(MESHES) + i) for i in range(len(EP_MESHES))]


def _mesh_config(i):
    return (MESHES + EP_MESHES)[i]


def _path(p) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)


@pytest.fixture(scope="module")
def trees():
    """``{family: (JAX shapes by flax path, port module on meta)}``."""
    from trlx_tpu.models import heads as jheads
    from trlx_tpu.models.registry import get_model_family as jax_family
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead, T5WithValueHead

    out = {}
    for name, arch in ARCHS.items():
        jf, pf = jax_family(name), port_family(name)
        arch = dict(arch, dtype="float32")
        jcfg = jf.config_cls.from_dict(arch)
        if name == "t5":
            model = jheads.T5WithValueHead(jcfg)
            init = lambda rng: model.init(rng, jnp.zeros((1, 4), jnp.int32),  # noqa: E731
                                          decoder_input_ids=jnp.zeros((1, 4), jnp.int32))
            port = T5WithValueHead(pf.config_cls.from_dict(arch), device="meta")
        else:
            model = jheads.CausalLMWithValueHead(jcfg, backbone_cls=jf.backbone_cls)
            init = lambda rng: model.init(rng, jnp.zeros((1, 8), jnp.int32))  # noqa: E731
            port = CausalLMWithValueHead(pf.config_cls.from_dict(arch), pf.backbone_cls,
                                         device="meta")
        shapes = jax.eval_shape(lambda rng: init(rng)["params"], jax.random.PRNGKey(0))
        flat = {_path(p): tuple(leaf.shape)
                for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
        out[name] = (shapes, flat, port)
    return out


def _jax_specs(shapes, config, rules):
    from trlx_tpu.parallel import make_mesh
    from trlx_tpu.parallel import make_partition_specs as jax_specs

    mesh = make_mesh(config)
    specs = jax_specs(shapes, mesh, rules)
    flat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_path(p): tuple(s) for p, s in flat}, dict(mesh.shape)


@pytest.mark.parametrize("family,mesh", CASES)
def test_specs_equal_jax_entry_by_entry(trees, family, mesh):
    from trlx_tpu.models.registry import get_model_family as jax_family

    shapes, flat, port = trees[family]
    config = _mesh_config(mesh)
    want, jax_sizes = _jax_specs(shapes, config, jax_family(family).partition_rules)
    sizes = mesh_sizes(config, 8)
    assert sizes == jax_sizes
    rules = port_family(family).partition_rules
    got = make_partition_specs(flat, sizes, rules)
    assert got == want
    # the port's module names carry the JAX paths, and module_specs the specs
    paths = flax_paths(port)
    assert sorted(p for p, _ in paths.values()) == sorted(flat)
    by_name = module_specs(port, sizes, rules)
    for name, (path, transposed) in paths.items():
        spec = want[path] + (None,) * (len(flat[path]) - len(want[path]))
        assert by_name[name] == (spec[::-1] if transposed else spec), name
    if config.get("fsdp", 1) > 1 or config.get("tp", 1) > 1:
        assert any(want.values())


RULE_ERRORS = {
    "missing_axis": ((r"mlp/c_fc/kernel", (None, "xx")), "names mesh axis 'xx'"),
    "indivisible": ((r"wte/embedding", ("tp", None)), "which does not divide 64"),
}


@pytest.mark.parametrize("case", list(RULE_ERRORS))
def test_rule_errors_raise_in_both_packages(trees, case):
    from jax.sharding import PartitionSpec as P

    from trlx_tpu.parallel import PartitionRuleError as JaxError
    from trlx_tpu.parallel import make_mesh
    from trlx_tpu.parallel import make_partition_specs as jax_specs

    shapes, flat, _ = trees["gpt2"]
    (pattern, spec), match = RULE_ERRORS[case]
    config = {"dp": -1, "tp": 8} if case == "indivisible" else {"dp": -1, "tp": 2}
    if case == "indivisible":
        flat = dict(flat, **{"transformer/wte/embedding": (60, 128)})
        shapes = jax.tree_util.tree_map(lambda x: x, shapes)
        shapes["transformer"]["wte"]["embedding"] = jax.ShapeDtypeStruct((60, 128), jnp.float32)
        match = "which does not divide 60"
    with pytest.raises(JaxError, match=match) as jerr:
        jax_specs(shapes, make_mesh(config), [(pattern, P(*spec))])
    with pytest.raises(PartitionRuleError, match=match) as perr:
        validate_rules(flat, mesh_sizes(config, 8), [(pattern, spec)])
    assert str(perr.value) == str(jerr.value)


def test_every_large_neox20b_param_is_sharded_on_its_yml_mesh():
    """``configs/ppo_neox20b.yml``'s ``{dp: -1, fsdp: 8, tp: 4}`` over 32
    ranks, on the 20B policy's shapes (the meta device: no memory)."""
    import os

    from trlx_tpu_torch.data.configs import TRLConfig
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = TRLConfig.load_yaml(os.path.join(root, "configs", "ppo_neox20b.yml"))
    family = port_family("gpt_neox")
    arch = family.config_cls.from_dict({
        "vocab_size": 50432, "hidden_size": 6144, "num_hidden_layers": 44,
        "num_attention_heads": 64, "max_position_embeddings": 2048, "rotary_pct": 0.25})
    model = CausalLMWithValueHead(arch, family.backbone_cls, device="meta")
    total = sum(p.numel() for p in model.parameters())
    assert 19e9 < total < 22e9, total
    sizes = mesh_sizes(cfg.train.training["mesh"], 32)
    assert (sizes["fsdp"], sizes["tp"], sizes["dp"]) == (8, 4, 1)
    specs = module_specs(model, sizes, family.partition_rules)
    params = dict(model.named_parameters())
    unsharded = [n for n, spec in specs.items()
                 if params[n].numel() >= 4_000_000
                 and np.prod([sizes[a] for a in spec if a]) <= 1]
    assert not unsharded, unsharded
    # the blocks' projections take both axes: 1/32 of each on a rank
    assert specs["transformer.h.0.attn.query_key_value.weight"] == ("tp", "fsdp")
    assert specs["transformer.h.0.attn.dense.weight"] == ("fsdp", "tp")


def test_one_rank_holds_everything_and_tp_index_takes_each_segment():
    from trlx_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
    from trlx_tpu_torch.models.heads import CausalLMWithValueHead
    from trlx_tpu_torch.parallel.mesh import MeshGroups
    from trlx_tpu_torch.parallel.partition import ShardedModule, make_shardings

    torch.manual_seed(0)
    model = CausalLMWithValueHead(GPT2Config(**ARCHS["gpt2"], dtype="float32"), GPT2Model)
    before = {n: p.clone() for n, p in model.state_dict().items()}
    groups = MeshGroups(mesh_sizes({"dp": -1}, 1))
    placements = make_shardings(model, groups.sizes, port_family("gpt2").partition_rules,
                                port_family("gpt2").tp_fused)
    assert placements["transformer.h.0.attn.c_attn.weight"].tp_parts == 3
    sharded = ShardedModule(model, placements, groups)
    for n, t in sharded.full_state_dict().items():
        assert torch.equal(t, before[n]), n
    assert all(held == full for held, full in sharded.shard_bytes().values())
    assert tp_index(12, 2, 1, parts=3).tolist() == [2, 3, 6, 7, 10, 11]
    assert tp_index(8, 4, 2).tolist() == [4, 5]
