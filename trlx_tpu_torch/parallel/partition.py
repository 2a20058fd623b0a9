"""Parameter partitioning: path-pattern rules -> per-parameter placements,
and the shards a rank holds (counterpart of
:mod:`trlx_tpu.parallel.partition`).

**What is sharded** is decided exactly as in the JAX package, by
:func:`make_partition_specs` over the flax paths and shapes of the
parameters (``models/convert.py``'s name map carries a port name to its
flax path, so the families' rule tables are the JAX ones): the first rule
whose regex matches the path contributes its axes (an axis of size 1 is a
no-op; an axis the mesh lacks, or a dim the axis does not divide, raises
:class:`PartitionRuleError`), then ``fsdp`` goes on the largest
still-unsharded divisible dim of every parameter of at least
``min_shard_size`` elements. Specs come from shapes and a dict of mesh
sizes, so they need no process group.

**How a rank holds it** follows torch's idiom (:class:`ShardedModule`):
the module's ``Parameter`` objects keep their identity and hold this
rank's shard (``p.data`` replaced), so the optimizer and its state are
per shard. A spec's ``tp`` dim is the slice tensor parallelism computes
on (whole heads: GPT-2's fused ``c_attn`` takes its slice of each of q, k
and v, ``tp_parts``); its ``fsdp`` dim is gathered around each use
(:meth:`ShardedModule.unsharded`, whose backward reduce-scatters the
gradient) and around the rollout copies. The layers' tensor-parallel
forwards are wired by :func:`apply_tensor_parallel` (column-parallel
projections, whose biases the rules leave replicated and which take their
slice at use, row-parallel ones, the LM head over vocabulary shards, the
embedding over hidden shards and the tied logits' partial sums).
"""

from __future__ import annotations

import contextlib
import math
import re
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from trlx_tpu_torch.parallel import collectives as C
from trlx_tpu_torch.parallel.mesh import AXIS_FSDP, AXIS_TP, BATCH_AXES

#: a rule: (regex searched in the "/"-joined flax path, per-dim mesh axes)
Spec = Tuple[Optional[str], ...]
Rules = Sequence[Tuple[str, Spec]]


class PartitionRuleError(ValueError):
    """A partition rule produced an invalid placement for a param: an axis
    name the mesh does not have, or a sharded dim the axis size does not
    divide (a configuration bug, raised where the rules are applied)."""


def make_partition_specs(
    shapes: Mapping[str, Sequence[int]],
    mesh_sizes: Mapping[str, int],
    rules: Optional[Rules] = None,
    min_shard_size: int = 2**14,
    validate: bool = True,
) -> Dict[str, Spec]:
    """``{flax path: spec}`` for ``{flax path: shape}`` on a mesh of
    ``mesh_sizes``: each spec a tuple of mesh axes (or ``None``) per dim,
    trailing ``None`` dropped, as ``tuple(PartitionSpec)`` of the JAX
    function. The first matching rule wins and contributes its axes of
    size > 1; ``fsdp`` then goes on the largest still-unsharded dim it
    divides, for parameters of at least ``min_shard_size`` elements. With
    ``validate``, a rule naming an axis the mesh lacks or a dim its axis
    does not divide raises :class:`PartitionRuleError`; a spec entry past
    a parameter's rank is ignored."""
    rules = list(rules or [])
    fsdp = mesh_sizes.get(AXIS_FSDP, 1)
    specs: Dict[str, Spec] = {}
    for name, shape in shapes.items():
        shape = tuple(int(s) for s in shape)
        base: List[Optional[str]] = [None] * len(shape)
        for pattern, pspec in rules:
            if not re.search(pattern, name):
                continue
            for i, ax in enumerate(pspec):
                if ax is None or i >= len(shape):
                    continue
                if validate and ax not in mesh_sizes:
                    raise PartitionRuleError(
                        f"partition rule {pattern!r} names mesh axis {ax!r} for param "
                        f"{name!r}, but the mesh axes are {sorted(mesh_sizes)}"
                    )
                n_ax = mesh_sizes.get(ax, 1)
                if n_ax > 1:
                    if shape[i] % n_ax != 0:
                        if validate:
                            raise PartitionRuleError(
                                f"partition rule {pattern!r} shards dim {i} of param "
                                f"{name!r} (shape {shape}) over axis {ax!r} of size "
                                f"{n_ax}, which does not divide {shape[i]}"
                            )
                    else:
                        base[i] = ax
            break
        if fsdp > 1 and math.prod(shape) >= min_shard_size:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if base[i] is None and shape[i] % fsdp == 0:
                    base[i] = AXIS_FSDP
                    break
        while base and base[-1] is None:
            base.pop()
        specs[name] = tuple(base)
    return specs


def validate_rules(shapes: Mapping[str, Sequence[int]], mesh_sizes: Mapping[str, int],
                   rules: Optional[Rules]) -> None:
    """Raise :class:`PartitionRuleError` if any rule places ``shapes``
    invalidly on a mesh of ``mesh_sizes`` (only shapes are read)."""
    make_partition_specs(shapes, mesh_sizes, rules, validate=True)


@dataclass(frozen=True)
class Placement:
    """How one parameter lies on the mesh, in the port's (torch) layout:
    ``spec`` names a mesh axis (or ``None``) for every dim; ``tp_parts``
    > 1 splits the ``tp`` dim into that many equal segments, each sliced
    by tp rank (GPT-2's fused [q | k | v]); ``tp_partial`` marks a
    parameter the rules replicate but a tensor-parallel forward uses
    through its tp slice (a column-parallel bias), whose gradient is then
    summed over ``tp``."""

    spec: Spec
    full_shape: Tuple[int, ...]
    tp_parts: int = 1
    tp_partial: bool = False

    def dim(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None


def module_specs(module: nn.Module, mesh_sizes: Mapping[str, int], rules: Optional[Rules],
                 min_shard_size: int = 2**14) -> Dict[str, Spec]:
    """``{port parameter name: spec}`` for ``module``'s parameters, the
    spec in the port's layout (a ``Linear`` weight's reversed from its
    flax kernel's), one entry per dim."""
    from trlx_tpu_torch.models.convert import flax_paths

    paths = flax_paths(module)
    params = dict(module.named_parameters())
    shapes = {}
    for name, (path, transposed) in paths.items():
        shape = tuple(params[name].shape)
        shapes[path] = shape[::-1] if transposed else shape
    flax_specs = make_partition_specs(shapes, mesh_sizes, rules, min_shard_size)
    out = {}
    for name, (path, transposed) in paths.items():
        ndim = params[name].dim()
        spec = list(flax_specs[path]) + [None] * (ndim - len(flax_specs[path]))
        out[name] = tuple(spec[::-1] if transposed else spec)
    return out


def make_shardings(module: nn.Module, mesh_sizes: Mapping[str, int], rules: Optional[Rules],
                   tp_fused: Mapping[str, int] = (), **kw) -> Dict[str, Placement]:
    """``{port parameter name: Placement}``: :func:`module_specs`, with
    the fused parameters' ``tp_parts`` (``tp_fused``: ``{name regex:
    parts}``, the family's)."""
    out = {}
    params = dict(module.named_parameters())
    for name, spec in module_specs(module, mesh_sizes, rules, **kw).items():
        parts = next((n for pat, n in dict(tp_fused).items() if re.search(pat, name)), 1)
        out[name] = Placement(spec, tuple(params[name].shape), parts)
    return out


def tp_index(size: int, tp: int, rank: int, parts: int = 1, device=None) -> torch.Tensor:
    """The indices along a dim of ``size`` that tp rank ``rank`` of ``tp``
    holds: its contiguous 1/tp of each of ``parts`` equal segments."""
    seg = size // parts
    width = seg // tp
    return torch.cat([torch.arange(j * seg + rank * width, j * seg + (rank + 1) * width,
                                   device=device) for j in range(parts)])


class ShardedModule:
    """``module``'s parameters sharded on the mesh of ``groups``
    (:class:`~trlx_tpu_torch.parallel.mesh.MeshGroups`) by
    ``placements`` (:func:`make_shardings`): construction slices every
    parameter to this rank's shard in place.

    - :meth:`unsharded`: a context in which every fsdp-sharded parameter
      reads as its gathered (tp-local) tensor, through
      :func:`~trlx_tpu_torch.parallel.collectives.gather_param` when
      ``grad`` (the backward's reduce-scatter fills the shard's ``.grad``);
    - :meth:`gathered`: one parameter's fsdp gather, optionally cast
      before the gather (the rollout copies, never a full f32 copy of a
      bf16 rollout);
    - :meth:`sync_grads`: after the backward, each gradient summed over
      the data axes its parameter is replicated on (and over ``tp`` for a
      ``tp_partial`` one);
    - :meth:`grad_sq_sum`: the squared global norm, each parameter counted
      once whatever its replication;
    - :meth:`full_tensor` / :meth:`local_tensor`: a parameter in the
      one-device layout and back (checkpoints).
    """

    def __init__(self, module: nn.Module, placements: Dict[str, Placement], groups):
        self.module = module
        self.placements = placements
        self.groups = groups
        self.names = {id(p): n for n, p in module.named_parameters()}
        self._slots = [(mod, pname, f"{mname}.{pname}" if mname else pname)
                       for mname, mod in module.named_modules()
                       for pname, p in mod._parameters.items() if p is not None]
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.data = self.local_tensor(name, p.data)

    # ----------------------------- layout -------------------------------- #

    def _tp_index(self, pl: Placement, dim: int, device) -> torch.Tensor:
        g = self.groups
        return tp_index(pl.full_shape[dim], g.size(AXIS_TP), g.index(AXIS_TP), pl.tp_parts,
                        device)

    def local_tensor(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of parameter ``name`` from its full tensor."""
        pl, g = self.placements[name], self.groups
        x = full
        for dim, ax in enumerate(pl.spec):
            if ax == AXIS_TP:
                x = x.index_select(dim, self._tp_index(pl, dim, x.device))
            elif ax == AXIS_FSDP:
                x = x.chunk(g.size(AXIS_FSDP), dim)[g.index(AXIS_FSDP)]
        return x.clone(memory_format=torch.contiguous_format)

    def full_tensor(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """Parameter ``name`` in the one-device layout from this rank's
        shard ``local`` (or a same-shaped optimizer moment); collective."""
        pl, g = self.placements[name], self.groups
        x = local
        fdim = pl.dim(AXIS_FSDP)
        if fdim is not None:
            x = C.all_gather(x, g.group(AXIS_FSDP), fdim)
        tdim = pl.dim(AXIS_TP)
        if tdim is not None:
            pieces = C.all_gather(x, g.group(AXIS_TP), tdim).chunk(g.size(AXIS_TP), tdim)
            out = x.new_empty(pl.full_shape)
            for r, piece in enumerate(pieces):
                idx = tp_index(pl.full_shape[tdim], g.size(AXIS_TP), r, pl.tp_parts, x.device)
                out.index_copy_(tdim, idx, piece)
            x = out
        return x

    def gathered(self, name: str, shard: torch.Tensor, grad: bool = False,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``shard`` of parameter ``name`` gathered over fsdp (tp stays
        local), cast to ``dtype`` first; with ``grad`` an autograd op."""
        fdim = self.placements[name].dim(AXIS_FSDP)
        if dtype is not None:
            shard = shard.to(dtype)
        if fdim is None:
            return shard
        if grad:
            return C.gather_param(shard, self.groups.group(AXIS_FSDP), fdim)
        with torch.no_grad():
            return C.all_gather(shard.detach(), self.groups.group(AXIS_FSDP), fdim)

    @contextlib.contextmanager
    def unsharded(self, grad: bool = False):
        """Every fsdp-sharded parameter reads as its gathered tensor inside
        the context (the module's ``Parameter`` objects are put back on
        exit; a graph built inside keeps the gathered tensors)."""
        swapped = []
        try:
            for mod, pname, name in self._slots:
                if self.placements[name].dim(AXIS_FSDP) is None:
                    continue
                p = mod._parameters[pname]
                mod._parameters[pname] = self.gathered(name, p, grad=grad and p.requires_grad)
                swapped.append((mod, pname, p))
            yield self.module
        finally:
            for mod, pname, p in swapped:
                mod._parameters[pname] = p

    # --------------------------- gradients ------------------------------- #

    def _reduce_axes(self, pl: Placement) -> Tuple[str, ...]:
        axes = tuple(a for a in BATCH_AXES if a not in pl.spec)
        return axes + ((AXIS_TP,) if pl.tp_partial else ())

    @torch.no_grad()
    def sync_grads(self, params: Iterable[nn.Parameter]) -> None:
        """Sum each gradient over the axes its parameter is replicated on
        among the data axes (a shard's fsdp sum came with the backward),
        and over ``tp`` for a ``tp_partial`` one: one flat all-reduce per
        group and kind of parameter."""
        g = self.groups
        buckets: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for p in params:
            if p.grad is None:
                continue
            axes = self._reduce_axes(self.placements[self.names[id(p)]])
            if axes:
                buckets.setdefault(axes, []).append(p.grad)
        for axes, grads in buckets.items():
            flat = torch.cat([t.reshape(-1).float() for t in grads])
            data = tuple(a for a in axes if a in BATCH_AXES)
            if data and g.size(*data) > 1:
                flat = C.all_reduce(flat, g.group(*data))
            if AXIS_TP in axes:
                flat = C.all_reduce(flat, g.group(AXIS_TP))
            for t, new in zip(grads, flat.split([t.numel() for t in grads])):
                t.copy_(new.view_as(t))

    def replication(self, name: str) -> int:
        """Ranks holding the same elements of parameter ``name``."""
        spec = self.placements[name].spec
        return self.groups.world // math.prod(self.groups.size(a) for a in spec if a)

    def grad_sq_sum(self, params: Sequence[nn.Parameter],
                    grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The squared global norm of ``grads`` (synced), summed over the
        world with each parameter's elements counted once."""
        local = sum((gr.float() ** 2).sum() / self.replication(self.names[id(p)])
                    for p, gr in zip(params, grads))
        return C.all_reduce(torch.as_tensor(local, dtype=torch.float32), self.groups.world_group)

    # --------------------------- checkpoints ----------------------------- #

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state dict in the one-device layout (collective)."""
        out = {}
        for name, t in self.module.state_dict().items():
            out[name] = self.full_tensor(name, t) if name in self.placements else t
        return out

    def local_state_dict(self, full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's shards of a one-device state dict (names the module
        lacks pass through, for ``load_state_dict`` to name)."""
        return {name: (self.local_tensor(name, t) if name in self.placements
                       and tuple(t.shape) == self.placements[name].full_shape else t)
                for name, t in full.items()}

    def shard_bytes(self) -> Dict[str, Tuple[int, int]]:
        """``{name: (bytes held here, full bytes)}`` of every parameter."""
        return {n: (p.numel() * p.element_size(),
                    math.prod(self.placements[n].full_shape) * p.element_size())
                for n, p in self.module.named_parameters()}


def shard_params(module: nn.Module, placements: Dict[str, Placement],
                 groups) -> ShardedModule:
    """Place ``module``'s parameters on the mesh of ``groups`` per
    ``placements``: each becomes this rank's shard, in place (the
    counterpart of the JAX ``shard_params``' ``device_put``)."""
    return ShardedModule(module, placements, groups)


# ---------------------------- tensor parallel --------------------------- #


class TensorParallel:
    """A layer's tensor-parallel forward over the ``tp`` process group
    (deep copies share it: the rollout copies run the same group).

    - ``"col"``: a column-parallel projection (its output features are
      this rank's slice); the input's gradient is summed over tp; the
      (replicated) bias is taken at the layer's ``tp_index``;
    - ``"row"``: a row-parallel projection on the local slice; the partial
      outputs are summed over tp, then the bias added;
    - ``"col_gather"``: an untied LM head over vocabulary shards, the
      logits gathered;
    - :meth:`embed` gathers an embedding's hidden-dim shards, and
      :meth:`tied_logits` sums the tied head's partial products over the
      hidden shards."""

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self

    def linear(self, mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
        dt = mod.compute_dtype
        w = mod.weight.to(dt)
        bias = None if mod.bias is None else mod.bias.to(dt)
        if mod.tp_mode == "row":
            out = C.reduce_from_group(F.linear(x.to(dt), w), self.group)
            return out if bias is None else out + bias
        x = C.copy_to_group(x.to(dt), self.group)
        if mod.tp_mode == "col":
            if bias is not None:
                bias = bias.index_select(0, mod.tp_index.to(bias.device))
            return F.linear(x, w, bias)
        out = C.gather_from_group(F.linear(x, w), self.group, -1)
        return out if bias is None else out + bias

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        return C.gather_from_group(x, self.group, -1)

    def tied_logits(self, hidden: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """``hidden @ emb.T`` in f32 with ``emb`` [V, D / tp] this rank's
        hidden slice: the partial products summed over tp."""
        h = C.scatter_to_group(hidden.float(), self.group, -1)
        return C.reduce_from_group(torch.matmul(h, emb.float().t()), self.group)


def apply_tensor_parallel(module: nn.Module, placements: Dict[str, Placement],
                          groups) -> Dict[str, Placement]:
    """Wire ``module``'s tensor-parallel forwards from its placements:
    each compute-dtype ``Linear`` whose weight is tp-sharded on its output
    dim runs ``"col"`` (``"col_gather"`` for an ``lm_head``), on its input
    dim ``"row"``; a column-parallel bias becomes ``tp_partial``; a model
    whose ``wte`` is tp-sharded on the hidden dim embeds and (tied) heads
    through :class:`TensorParallel`. Returns the updated placements; a
    no-op at tp = 1."""
    if groups.size(AXIS_TP) <= 1:
        return placements
    ctx = TensorParallel(groups.group(AXIS_TP))
    out = dict(placements)
    for mname, mod in module.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(mod, nn.Linear) and hasattr(mod, "compute_dtype"):
            spec = out[prefix + "weight"].spec
            if spec[0] == AXIS_TP:
                mod.tp_mode = "col_gather" if mname.split(".")[-1] == "lm_head" else "col"
            elif spec[1] == AXIS_TP:
                mod.tp_mode = "row"
            else:
                continue
            mod.tp = ctx
            if mod.tp_mode == "col" and mod.bias is not None:
                wpl = out[prefix + "weight"]
                bias_name = prefix + "bias"
                out[bias_name] = replace(out[bias_name], tp_parts=wpl.tp_parts, tp_partial=True)
                mod.tp_index = tp_index(wpl.full_shape[0], groups.size(AXIS_TP),
                                        groups.index(AXIS_TP), wpl.tp_parts, mod.weight.device)
        elif isinstance(getattr(mod, "wte", None), nn.Embedding) and hasattr(mod, "embed"):
            if out[prefix + "wte.weight"].spec[1:2] == (AXIS_TP,):
                mod.tp = ctx
    return out

