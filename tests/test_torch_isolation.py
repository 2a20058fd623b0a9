"""The port stands alone: importing every module of ``trlx_tpu_torch``
loads no JAX, no flax and nothing of ``trlx_tpu``; no module imports them,
calls a library attention (``scaled_dot_product_attention``, cuDNN
attention, flash-attention packages) or ``torch.compile``; and the HF
checkpoint loader works without ``transformers`` and ``safetensors``,
which the card's machine does not have."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "trlx_tpu_torch")
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax", "trlx_tpu",
                   "flash_attn", "xformers"}


def _modules():
    names = ["trlx_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="trlx_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_importing_every_module_loads_no_jax_or_reference():
    mods = _modules()
    for name in ("inference.engine", "ops.ring_attention", "parallel", "parallel.mesh",
                 "parallel.distributed", "parallel.partition", "parallel.collectives",
                 "parallel._mp_smoke", "sweep", "sweep.__main__", "sweep.train_funcs",
                 "sweep.wandb_report", "examples", "examples.randomwalks"):
        assert f"trlx_tpu_torch.{name}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"importing the port loaded {bad}"


@pytest.mark.parametrize("module", ["tracer", "metrics", "run_ledger"])
def test_telemetry_core_imports_no_torch(module):
    """The tracer, the registry and the run ledger import only the standard
    library (the ledger's platform probe imports torch when called), so a
    span can never touch the device."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module('trlx_tpu_torch.telemetry.{module}')\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    heavy = [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS | {"torch", "numpy"}]
    assert not heavy, f"importing telemetry.{module} loaded {heavy}"


@pytest.mark.parametrize(
    "path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_module_imports_and_calls_stay_in_bounds(path):
    tree = ast.parse(open(path).read(), filename=path)
    problems = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]] if node.level == 0 else []
        else:
            roots = []
        problems += [f"imports {r}" for r in roots if r in FORBIDDEN_ROOTS]
        if isinstance(node, ast.Attribute):
            if node.attr in ("scaled_dot_product_attention", "_scaled_dot_product_attention"):
                problems.append("calls scaled_dot_product_attention")
            if node.attr == "compile" and isinstance(node.value, ast.Name) and node.value.id == "torch":
                problems.append("calls torch.compile")
            if "cudnn" in node.attr and "attention" in node.attr:
                problems.append(f"calls {node.attr}")
        if isinstance(node, ast.Name) and node.id == "scaled_dot_product_attention":
            problems.append("names scaled_dot_product_attention")
    assert not problems, f"{os.path.relpath(path, ROOT)}: {problems}"


def test_checkpoint_loader_needs_neither_transformers_nor_safetensors(tmp_path):
    """The H100 machine has neither package: the loader imports neither,
    and reads a checkpoint directory in both formats with both blocked."""
    path = os.path.join(PKG, "models", "conversion.py")
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert not roots & {"transformers", "safetensors"}, roots

    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    tensors = {"transformer.wte.weight": torch.randn(8, 4), "transformer.wpe.weight": torch.randn(6, 4),
               "transformer.ln_f.weight": torch.randn(4), "transformer.ln_f.bias": torch.randn(4)}
    for name, shape in (("ln_1", (4,)), ("ln_2", (4,)), ("attn.c_attn", (4, 12)),
                        ("attn.c_proj", (4, 4)), ("mlp.c_fc", (4, 16)), ("mlp.c_proj", (16, 4))):
        tensors[f"transformer.h.0.{name}.weight"] = torch.randn(*shape)
        tensors[f"transformer.h.0.{name}.bias"] = torch.randn(shape[-1])
    hf_config = {"vocab_size": 8, "n_positions": 6, "n_embd": 4, "n_layer": 1, "n_head": 1}
    for fmt in ("safetensors", "bin"):
        d = tmp_path / fmt
        d.mkdir()
        (d / "config.json").write_text(json.dumps(hf_config))
        if fmt == "safetensors":
            chip_smoke.write_safetensors(tensors, str(d / "model.safetensors"))
        else:
            torch.save(tensors, str(d / "pytorch_model.bin"))
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "from trlx_tpu_torch.models.conversion import load_gpt2_checkpoint\n"
        f"for d in ({str(tmp_path / 'safetensors')!r}, {str(tmp_path / 'bin')!r}):\n"
        "    config, state = load_gpt2_checkpoint(d)\n"
        "    assert config.n_layer == 1 and state['h.0.attn.c_attn.weight'].shape == (12, 4)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_chip_smoke_imports_nothing_of_jax():
    """``chip_smoke.py`` runs on the card's machine, which has no JAX: it
    imports neither JAX, flax nor the JAX package, in its source or when
    imported (it times SDPA as a yardstick, so the attention rule above
    does not apply to it)."""
    path = os.path.join(ROOT, "chip_smoke.py")
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert not roots & FORBIDDEN_ROOTS, sorted(roots & FORBIDDEN_ROOTS)
    code = "import json, sys\nimport chip_smoke\nprint(json.dumps(sorted(sys.modules)))\n"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN_ROOTS]
