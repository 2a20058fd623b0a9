"""The port's ring attention (``trlx_tpu_torch/ops/ring_attention.py``) in
gloo process groups on the CPU, against the JAX package's
``ring_attention_sharded`` on the suite's 8 virtual CPU devices.

Each world layout spawns its ranks once for the module
(``tests/_torch_ring_worker.py``, which imports only torch and the port,
so no rank loads JAX): ``sp = 2`` (2 ranks), ``sp = 4`` (4 ranks) and
``dp = 2 x sp = 2`` (4 ranks). The ranks rendezvous through a ``file://``
store under the test's temporary directory and run with one thread each.
On ``tests/test_ring_attention.py``'s inputs (B = 8 // sp * 2, T = 16, H =
2, D = 8, a padded tail of 3 keys on row 0) every rank runs causal on and
off, ``impl="flash"`` and ``"naive"``, and saves its output and the (q, k,
v) gradients of sum(out²); the shards, put back in place by each rank's
mesh coordinate, must match the JAX ring's output and gradients on a mesh
of the same layout. The two impls must agree; ``chip_smoke.py``'s lockstep
driver (every rank's pass in one process) must give the gloo ring's
output and gradients bit for bit, from the same cotangent 2 * out; the
mesh, its DTensor placements and the runtime must report what each rank
expects; ``mesh_sizes`` must give the JAX ``make_mesh``'s sizes and raise
its errors.

Tolerances: outputs 2e-6 and gradients 1e-5, tighter than the 2e-5 and
2e-4 the JAX tests hold their ring to against dense attention (both rings
compute in f32 and combine blocks in the same order; they differ in the
order of the sums inside a block: up to 7.2e-7 and 2.9e-6 here); the
impls against each other 1e-5 on both (up to 2.8e-6).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trlx_tpu.ops import ring_attention as jra
from trlx_tpu.parallel import mesh as jmesh
from trlx_tpu_torch.ops import ring_attention as tra
from trlx_tpu_torch.parallel import distributed, make_mesh
from trlx_tpu_torch.parallel.mesh import mesh_sizes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
from _torch_ring_worker import CASES, batch_for, case_name, ring_inputs  # noqa: E402

WORKER = os.path.join(ROOT, "tests", "_torch_ring_worker.py")
LAYOUTS = {"sp2": {"sp": 2}, "sp4": {"sp": 4}, "dp2_sp2": {"dp": 2, "sp": 2}}
ATOL_OUT = 2e-6
ATOL_GRAD = 1e-5
ATOL_IMPLS = 1e-5
GRADS = ("dq", "dk", "dv")


def _world(layout):
    return layout.get("dp", 1) * layout.get("fsdp", 1) * layout["sp"]


def _spawn(layout, tmp):
    """Every rank of ``layout`` as its own process; returns their saved
    records, by rank."""
    world = _world(layout)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, json.dumps(layout), str(tmp / "store"), str(tmp)],
        env={**env, "RANK": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


def _assemble(records, layout, key, name):
    """The whole [B, T, ...] tensor from every rank's shard of ``name``,
    each placed by its dp and sp coordinates."""
    dp, sp = layout.get("dp", 1), layout["sp"]
    rows = [[None] * sp for _ in range(dp)]
    for rec in records:
        coord = rec["coordinate"]
        rows[coord[0]][coord[3]] = rec[key][name]
    return torch.cat([torch.cat(r, dim=1) for r in rows], dim=0)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def ring_run(request, tmp_path_factory):
    """One spawn of the layout's ranks, the assembled results of every
    case, and the JAX ring's on the same inputs."""
    layout = LAYOUTS[request.param]
    records = _spawn(layout, tmp_path_factory.mktemp(request.param))
    q, k, v, kv_mask = ring_inputs(batch_for(layout))
    mesh = jmesh.make_mesh(layout, devices=jax.devices()[:_world(layout)])
    port, ref = {}, {}
    for causal, impl in CASES:
        name = case_name(causal, impl)
        port[name] = {x: _assemble(records, layout, name, x) for x in ("out", *GRADS)}

        def loss(q, k, v, causal=causal, impl=impl):
            out = jra.ring_attention_sharded(q, k, v, mesh, kv_mask=jnp.asarray(kv_mask),
                                             causal=causal, impl=impl)
            return jnp.sum(out ** 2), out

        (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(x) for x in (q, k, v)))
        ref[name] = {"out": np.asarray(out), **{g: np.asarray(x) for g, x in zip(GRADS, grads)}}
    return {"name": request.param, "layout": layout, "records": records, "port": port,
            "ref": ref, "inputs": (q, k, v, kv_mask)}


@pytest.mark.parametrize("case", [case_name(*c) for c in CASES])
def test_ring_matches_jax(ring_run, case):
    port, ref = ring_run["port"][case], ring_run["ref"][case]
    for name in ("out", *GRADS):
        assert port[name].shape == ref[name].shape, name
        np.testing.assert_allclose(port[name].numpy(), ref[name],
                                   atol=ATOL_OUT if name == "out" else ATOL_GRAD,
                                   err_msg=f"{ring_run['name']} {case} {name}")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_naive(ring_run, causal):
    flash = ring_run["port"][case_name(causal, "flash")]
    naive = ring_run["port"][case_name(causal, "naive")]
    for name in ("out", *GRADS):
        np.testing.assert_allclose(flash[name].numpy(), naive[name].numpy(), atol=ATOL_IMPLS,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_lockstep_matches_gloo_bit_for_bit(ring_run, causal):
    """``chip_smoke.py``'s lockstep driver (the sp ring's ranks in one
    process, one thread, as each gloo rank ran) against the gloo ring."""
    layout = ring_run["layout"]
    gloo = ring_run["port"][case_name(causal, "flash")]
    inputs = [torch.from_numpy(x) for x in ring_run["inputs"]]
    rows = inputs[0].shape[0] // layout.get("dp", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # one sp ring per dp shard of the batch, as the gloo ranks ran them
        for lo in range(0, inputs[0].shape[0], rows):
            q, k, v, kv_mask = (x[lo:lo + rows] for x in inputs)
            out, lse, *grads = chip_smoke.lockstep_ring(
                torch, tra, q, k, v, kv_mask, 2 * gloo["out"][lo:lo + rows], layout["sp"],
                causal)
            assert lse.shape == (rows, q.shape[2], q.shape[1])
            for name, got in zip(("out", *GRADS), (out, *grads)):
                assert torch.equal(got, gloo[name][lo:lo + rows]), (lo, name)
    finally:
        torch.set_num_threads(threads)


def test_mesh_and_runtime_in_every_rank(ring_run):
    layout, records = ring_run["layout"], ring_run["records"]
    sizes = mesh_sizes(layout, _world(layout))
    coords = set()
    for rank, rec in enumerate(records):
        assert rec["dim_names"] == ["dp", "fsdp", "tp", "sp", "pp", "ep"]
        assert rec["mesh_shape"] == [sizes[a] for a in rec["dim_names"]]
        # ranks fill the mesh row-major, so sp neighbours are adjacent ranks
        assert rec["coordinate"] == list(np.unravel_index(rank, rec["mesh_shape"]))
        assert rec["sp_rank"] == rec["coordinate"][3]
        assert rec["main"] == (rank == 0)
        assert rec["broadcast"] == 100  # rank 0's value
        assert rec["local_batch"] == 8 // layout.get("dp", 1)
        assert rec["batch_sharding_ok"] and rec["replicated_ok"]
        assert "impl must be 'flash' or 'naive'" in rec["impl_refused"]
        coords.add(tuple(rec["coordinate"]))
    assert len(coords) == len(records)


MESH_CONFIGS = [None, {"dp": -1}, {"sp": 2}, {"dp": 2, "sp": 2}, {"dp": -1, "sp": 4},
                {"fsdp": -1, "tp": 2}, {"dp": 1, "fsdp": 1, "tp": 1}, {"ep": 2, "pp": -1},
                {"dp": -1, "fsdp": -1}, {"sp": 3}, {"cp": 2}, {"dp": 2}]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("config", MESH_CONFIGS, ids=json.dumps)
def test_mesh_sizes_match_jax_make_mesh(config, n):
    """The sizes, and the ``ValueError`` (message and all) where the JAX
    ``make_mesh`` raises one, for ``n`` devices."""
    try:
        want = jmesh.make_mesh(config, devices=jax.devices()[:n])
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            mesh_sizes(config, n)
        assert str(got.value) == str(err)
        return
    got = mesh_sizes(config, n)
    assert list(got) == list(want.axis_names)
    assert tuple(got.values()) == tuple(want.devices.shape)


def test_single_process_runtime_without_a_launcher(monkeypatch):
    """Nothing launched, nothing asked for: ``initialize`` starts no group,
    the process is the main one, a host value is its own, the barrier
    returns, and ``make_mesh`` names what to call first."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize("cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.is_main_process()
    assert distributed.broadcast_host_value({"a": 1}) == {"a": 1}
    distributed.barrier()
    with pytest.raises(RuntimeError, match="initialize first"):
        make_mesh({"dp": -1}, device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        distributed.initialize("tpu")


def test_sharded_entry_refuses_tensors_off_the_mesh_device():
    """CUDA tensors never go through a gloo mesh, nor CPU ones through an
    NCCL mesh: the device types must agree before any exchange."""

    class CudaMesh:
        device_type = "cuda"

    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="cpu tensors on a cuda mesh"):
        tra.ring_attention_sharded(q, q, q, CudaMesh())
