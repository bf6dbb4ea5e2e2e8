"""Placement of the train state over a mesh: replicated (data parallel) or
sharded (FSDP), and the update that keeps it so.

Counterpart of ``ddpm_diffusion_model_tpu/parallel/sharding.py``.  JAX
places each leaf and lets XLA emit the collectives; the port calls them
by hand, in :class:`StatePlacement`:

- **Replicated** (``fsdp=False``): every rank holds the whole state, made
  equal by a broadcast from rank 0.  After the backward the gradients and
  the loss are summed over every rank in one ``all_reduce`` and divided by
  the world size times the micro-batches a rank takes, so the update is
  the single-process update of the rank-major global batch.
- **FSDP** (``fsdp=True``): each leaf that :func:`fsdp_leaf_spec` shards
  (the largest dimension the ``fsdp`` axis divides) keeps one shard of
  both Adam moments and of the EMA per rank of the ``fsdp`` axis; the
  leaves it keeps replicated are handled as under data parallelism.  A
  step reduce-scatters the sharded gradients (and sums them over the other
  axes), clips by the global norm
  ``sqrt(all_reduce(sum of local |g_shard|^2) + sum |g_repl|^2)`` (a
  replicated leaf counted once), runs AdamW and the EMA on this rank's
  shard of each weight (a view of the model's full weight) only, and
  all-gathers the updated shards into the model's weights, which the next
  forward reads.  The full weights stay on every card between steps; the
  optimizer state and the EMA are what the shards save.

The batch of a placed step is split over the ``data`` and ``fsdp`` axes
(rank-major blocks, :func:`~.mesh.step_batch_sharding`); the port's FSDP
ranks each take their own rows, where JAX splits the batch over ``data``
alone.  The ranks along any other axis (the ring's ``cp``; ``model``,
``expert`` and ``pp``) take the same rows and compute the same gradients,
so the sum over every rank divided by the world size is the batch's mean
all the same, but for the leaves the R ranks of a tensor, expert or
pipeline axis each compute in part (a head group's ``qkv`` rows, an expert
group, a stage's blocks; zeros elsewhere): their parts sum to the whole,
so those are divided by the world size over R (:func:`partial_leaves`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import BatchSharding, axis_size, step_batch_sharding, world_size

__all__ = ["fsdp_leaf_spec", "state_sharding", "place_state", "unplace_state",
           "put_global", "place_params", "partial_leaves", "StatePlacement"]


def fsdp_leaf_spec(leaf, mesh, axis: str = "fsdp") -> tuple:
    """Shard the largest dimension divisible by the axis size; replicate
    when nothing divides (small biases and scales stay replicated).  The
    result is JAX's ``PartitionSpec`` as a tuple: ``()`` replicated, else
    one entry per dimension with ``axis`` at the sharded one.  ``leaf`` is
    a tensor or anything with a ``shape``."""
    if axis not in tuple(mesh.mesh_dim_names or ()):
        return ()
    size = axis_size(mesh, axis)
    shape = tuple(getattr(leaf, "shape", ()) or ())
    if size <= 1 or not hasattr(leaf, "shape") or len(shape) == 0:
        return ()
    dims = sorted(range(len(shape)), key=lambda d: -shape[d])
    for d in dims:
        if shape[d] % size == 0 and shape[d] >= size:
            spec = [None] * len(shape)
            spec[d] = axis
            return tuple(spec)
    return ()


def _sharded_dim(spec: tuple) -> Optional[int]:
    for d, a in enumerate(spec):
        if a is not None:
            return d
    return None


def _comm_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast(tensors: Sequence[torch.Tensor], device: torch.device,
               src: int = 0) -> None:
    """Rank ``src``'s values into ``tensors`` (in place) on every rank: one
    broadcast per dtype of a flat buffer on the backend's device."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dt, ts in by_dtype.items():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in ts])
        dist.broadcast(flat, src)
        off = 0
        for t in ts:
            n = t.numel()
            with torch.no_grad():
                t.copy_(flat[off:off + n].view(t.shape))
            off += n


def _memory_order(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` whose logical order is its memory order: NHWC for a
    channels_last 4-D tensor (the U-Net's conv weights and their grads)."""
    if (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)):
        return t.permute(0, 2, 3, 1)
    return t


def _local_shard(t: torch.Tensor, dim: int, parts: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``parts`` of ``t`` along ``dim``, as a new
    contiguous tensor."""
    n = t.shape[dim] // parts
    return t.detach().narrow(dim, index * n, n).contiguous()


@dataclasses.dataclass
class StatePlacement:
    """How a :class:`~..training.state.TrainState` lies over ``mesh``, and
    the update that keeps it there (see the module docstring).

    ``specs`` maps each parameter name to its sharded dimension (None:
    replicated) and ``shapes`` to its whole shape.  ``batch`` is the placed
    step's batch split, over the ``data`` and ``fsdp`` axes."""

    mesh: Any
    fsdp: bool
    specs: Dict[str, Optional[int]]
    shapes: Dict[str, torch.Size]
    batch: BatchSharding
    axis: str = "fsdp"

    # -- the fsdp axis
    @property
    def shard_parts(self) -> int:
        names = tuple(self.mesh.mesh_dim_names)
        return axis_size(self.mesh, self.axis) if self.axis in names else 1

    @property
    def shard_index(self) -> int:
        names = tuple(self.mesh.mesh_dim_names)
        if self.axis not in names:
            return 0
        return int(self.mesh.get_coordinate()[names.index(self.axis)])

    def _shard_group(self):
        return self.mesh.get_group(self.axis)

    def _data_group(self):
        """The ranks that hold the same shards (every axis but ``fsdp``);
        None when that is a single rank."""
        others = [a for a in self.mesh.mesh_dim_names if a != self.axis]
        if world_size() == self.shard_parts:
            return None
        if len(others) == 1:
            return self.mesh.get_group(others[0])
        return self.mesh[tuple(others)]._flatten().get_group()

    @property
    def device(self) -> torch.device:
        return _comm_device(self.mesh)

    def sharded_names(self) -> List[str]:
        return [n for n, d in self.specs.items() if d is not None]

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole leaf ``t`` of parameter ``name``
        (a view; ``t`` itself when the leaf is replicated)."""
        d = self.specs[name]
        if d is None:
            return t
        n = t.shape[d] // self.shard_parts
        return t.narrow(d, self.shard_index * n, n)

    # -- draws
    def dropout_generator(self, shared: torch.Generator) -> torch.Generator:
        """The generator a rank's dropout masks draw from: ``shared`` itself
        when the batch is not split (the single-process step's bits), else a
        generator seeded from ``shared``'s state and the rank's batch block,
        so the blocks' masks differ (the ranks that share a block draw the
        same) and a resumed run draws them again."""
        if self.batch.shards == 1:
            return shared
        state = shared.get_state().numpy().tobytes()
        digest = hashlib.blake2b(state + self.batch.index.to_bytes(4, "little"),
                                 digest_size=8).digest()
        seed = int.from_bytes(digest, "little") >> 1
        return torch.Generator(device=shared.device).manual_seed(seed)

    # -- the update
    def finish_update(self, state, tx, params: List[torch.Tensor], accum: int,
                      sums: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, Tuple]:
        """The tail of a placed update, in place: gradients and ``sums``
        (0-d metrics of this rank's micro-batches, summed) reduced over the
        ranks and divided by the world size times ``accum`` (a leaf whose
        gradient the R ranks of a tensor, expert or pipeline axis each
        compute in part, :func:`partial_leaves`, by that over R: its parts
        sum to the whole), the clip, AdamW and the EMA (on the local shards
        under FSDP, whose weights are then gathered), the grads cleared.
        Returns (pre-clip global grad norm, the metrics' global means)."""
        from ..ops.fused_update import adamw_
        from ..training.ema import ema_update

        names = list(self.specs)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        scale = float(accum * world_size())
        partial = partial_leaves(state.model)
        scales = [scale / partial.get(n, 1) for n in names]
        sharded = [i for i, n in enumerate(names) if self.specs[n] is not None]
        repl = [i for i, n in enumerate(names) if self.specs[n] is None]
        sums = [s.detach().reshape(1).float() for s in sums]
        # replicated leaves and the metrics: one all_reduce over every rank
        # of one buffer, filled and emptied in each grad's memory order (so
        # by one cat and one multi-tensor copy)
        views = [_memory_order(grads[i]) for i in repl]
        flat = torch.cat([v.reshape(-1) for v in views] + sums)
        dist.all_reduce(flat)
        parts = flat.split([v.numel() for v in views] + [1] * len(sums))
        if views:
            torch._foreach_copy_(views, [p.view(v.shape) for p, v in zip(parts, views)])
        means = tuple(p[0] / scale for p in parts[len(views):])
        if not sharded:  # data parallel, or an fsdp axis of 1
            torch._foreach_div_(grads, scales)
            grad_norm = adamw_(tx, params, grads, state.opt_state)
            ema_update(state.ema_params, dict(state.model.named_parameters()),
                       state.ema_decay)
        else:
            shard_grads = self._reduce_scatter([grads[i] for i in sharded],
                                               [self.specs[names[i]] for i in sharded])
            upd_grads = list(grads)
            for j, i in enumerate(sharded):
                upd_grads[i] = shard_grads[j]
            torch._foreach_div_(upd_grads, scales)
            sq = torch.zeros((), dtype=torch.float32, device=self.device)
            if sharded:
                norms = torch._foreach_norm([upd_grads[i].float() for i in sharded])
                sq = torch.stack(norms).square().sum()
            sq = sq.reshape(1)
            dist.all_reduce(sq)  # each shard is held by world / parts ranks
            sq = sq[0] / float(world_size() // self.shard_parts)
            if repl:
                norms = torch._foreach_norm([upd_grads[i].float() for i in repl])
                sq = sq + torch.stack(norms).square().sum()
            grad_norm = torch.sqrt(sq)
            model_params = dict(state.model.named_parameters())
            # a sharded leaf's block as a dense copy, laid out as its moments,
            # shadow and gradient shards are; a replicated leaf itself
            upd_params = [self.shard(n, model_params[n].detach()) for n in names]
            for i in sharded:
                upd_params[i] = upd_params[i].contiguous()
            adamw_(tx, upd_params, upd_grads, state.opt_state, grad_norm=grad_norm)
            ema_update(state.ema_params, dict(zip(names, upd_params)), state.ema_decay)
            self.gather_params(state.model, {names[i]: upd_params[i] for i in sharded})
        for p in params:
            p.grad = None
        state.step += 1
        return grad_norm, means

    def _reduce_scatter(self, grads: List[torch.Tensor], dims: List[int]
                        ) -> List[torch.Tensor]:
        """Each full gradient's sum over every rank, this rank's shard of it
        (along its dim), through one ``reduce_scatter_tensor`` over the
        ``fsdp`` axis and one ``all_reduce`` over the others."""
        if not grads:
            return []
        parts = self.shard_parts
        rows = [g.movedim(d, 0).contiguous().reshape(parts, -1) for g, d in zip(grads, dims)]
        buf = torch.cat(rows, dim=1)
        out = torch.empty(buf.shape[1], dtype=buf.dtype, device=buf.device)
        dist.reduce_scatter_tensor(out, buf.reshape(-1), group=self._shard_group())
        data = self._data_group()
        if data is not None:
            dist.all_reduce(out, group=data)
        shards, off = [], 0
        for g, d, r in zip(grads, dims, rows):
            n = r.shape[1]
            moved = list(g.movedim(d, 0).shape)
            moved[0] //= parts
            shards.append(out[off:off + n].view(moved).movedim(0, d).contiguous())
            off += n
        return shards

    def _all_gather(self, shards: List[torch.Tensor], dims: List[int],
                    shapes: List[torch.Size]) -> List[torch.Tensor]:
        """The full tensors of ``shards`` (this rank's, along ``dims``) from
        every rank of the ``fsdp`` axis, through one
        ``all_gather_into_tensor``."""
        if not shards:
            return []
        parts = self.shard_parts
        flat = torch.cat([s.movedim(d, 0).contiguous().reshape(-1)
                          for s, d in zip(shards, dims)])
        out = torch.empty(parts * flat.numel(), dtype=flat.dtype, device=flat.device)
        dist.all_gather_into_tensor(out, flat, group=self._shard_group())
        out = out.view(parts, -1)
        full, off = [], 0
        for s, d, shape in zip(shards, dims, shapes):
            n = s.numel()
            moved = list(torch.empty(shape, device="meta").movedim(d, 0).shape)
            full.append(out[:, off:off + n].reshape(moved).movedim(0, d))
            off += n
        return full

    @torch.no_grad()
    def gather_params(self, model: torch.nn.Module, shards: Dict[str, torch.Tensor]) -> None:
        """The model's weights whole from every rank's shard of them (FSDP):
        each rank's own block is ``shards[name]``, the one its update
        wrote."""
        named = dict(model.named_parameters())
        keys = self.sharded_names()
        full = self._all_gather([shards[k] for k in keys],
                                [self.specs[k] for k in keys],
                                [self.shapes[k] for k in keys])
        for k, f in zip(keys, full):
            named[k].copy_(f)

    def full(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tree`` (name -> this rank's shard or the whole leaf) with every
        sharded leaf gathered whole; a collective every rank calls."""
        if not self.fsdp:
            return dict(tree)
        keys = [k for k in tree if self.specs.get(k) is not None]
        full = self._all_gather([tree[k] for k in keys], [self.specs[k] for k in keys],
                                [self.shapes[k] for k in keys])
        out = dict(tree)
        out.update(zip(keys, full))
        return out

    def full_opt_state(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """The optimizer state with both moments gathered whole."""
        names = list(self.specs)
        mu = self.full(dict(zip(names, opt_state["mu"])))
        nu = self.full(dict(zip(names, opt_state["nu"])))
        return dict(opt_state, mu=[mu[n] for n in names], nu=[nu[n] for n in names])


def partial_leaves(model: torch.nn.Module) -> Dict[str, int]:
    """The parameters whose gradient each rank of an axis computes in part
    in this step, mapped to the axis's size R: the attention leaves under a
    ``tensor_parallel_mesh``, the experts under an ``expert_parallel_mesh``
    (the ambient contexts the step runs in) and the blocks of a
    :class:`~.pp.PipelinedDiT`.  The other leaves every rank computes whole
    for its rows."""
    from .ep import ep_partial_leaves
    from .tp import tp_partial_leaves

    out = dict(tp_partial_leaves(model))
    out.update(ep_partial_leaves(model))
    own = getattr(model, "partial_leaves", None)
    if callable(own):
        out.update(own())
    return out


def state_sharding(state, mesh, fsdp: bool = False) -> Dict[str, Any]:
    """A TrainState-shaped tree of specs (JAX ``PartitionSpec`` tuples):
    ``()`` replicated, else :func:`fsdp_leaf_spec` of each leaf under
    ``fsdp``."""

    def leaf(x) -> tuple:
        return fsdp_leaf_spec(x, mesh) if fsdp else ()

    named = dict(state.model.named_parameters())
    specs = {n: leaf(p) for n, p in named.items()}
    return {"step": (), "params": specs, "opt_state": {"mu": dict(specs), "nu": dict(specs)},
            "ema_params": dict(specs), "ema_decay": (), "rng": ()}


def place_state(state, mesh, fsdp: bool = False):
    """The state over ``mesh``: every tensor and the generator broadcast from
    rank 0 (replication), then, under ``fsdp``, the moments and the EMA cut
    to this rank's shard by :func:`fsdp_leaf_spec` (the model keeps its full
    weights; the update writes this rank's block of each).  A state placed before
    is taken whole again first (its shards gathered).  Returns a new
    TrainState whose ``placement`` drives the update."""
    if getattr(state, "placement", None) is not None:
        state = unplace_state(state)
    device = _comm_device(mesh)
    names = [n for n, _ in state.model.named_parameters()]
    named = dict(state.model.named_parameters())
    opt = state.opt_state
    _broadcast([named[n] for n in names] + list(opt["mu"]) + list(opt["nu"])
               + [state.ema_params[n] for n in names], device)
    gen_state = state.generator.get_state().clone()
    _broadcast([gen_state], device)
    state.generator.set_state(gen_state)
    specs = {n: (_sharded_dim(fsdp_leaf_spec(named[n], mesh)) if fsdp else None)
             for n in names}
    placement = StatePlacement(mesh=mesh, fsdp=bool(fsdp), specs=specs,
                               shapes={n: named[n].shape for n in names},
                               batch=step_batch_sharding(mesh))
    if not fsdp:
        return dataclasses.replace(state, placement=placement)
    parts, index = placement.shard_parts, placement.shard_index

    def cut(n, t):
        d = specs[n]
        return t if d is None else _local_shard(t, d, parts, index)

    opt = dict(opt, mu=[cut(n, m) for n, m in zip(names, opt["mu"])],
               nu=[cut(n, v) for n, v in zip(names, opt["nu"])])
    ema = {n: cut(n, e) for n, e in state.ema_params.items()}
    return dataclasses.replace(state, opt_state=opt, ema_params=ema, placement=placement)


def unplace_state(state):
    """The state whole on every rank (its shards gathered; a collective),
    with no placement: what a checkpoint saves."""
    placement = state.placement
    if placement is None:
        return state
    return dataclasses.replace(state, opt_state=placement.full_opt_state(state.opt_state),
                               ema_params=placement.full(state.ema_params),
                               placement=None)


def place_params(params, mesh, specs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Rank 0's values of ``params`` (a module or a name -> tensor map) on
    every rank, each leaf cut to this rank's block along the dimension its
    spec in ``specs`` names an axis at (``()``: whole)."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else dict(params)
    leaves = [t.detach().clone() for t in named.values()]
    _broadcast(leaves, _comm_device(mesh))
    names = tuple(mesh.mesh_dim_names)
    out = {}
    for (name, _t), leaf in zip(named.items(), leaves):
        spec = tuple(specs.get(name, ()))
        d = _sharded_dim(spec)
        if d is not None:
            leaf = _local_shard(leaf, d, axis_size(mesh, spec[d]),
                                int(mesh.get_coordinate()[names.index(spec[d])]))
        out[name] = leaf
    return out


def put_global(tree: Any, mesh, spec: tuple = ()) -> Any:
    """A copy of ``tree`` (tensors in dicts, lists and tuples) with rank 0's
    values on every rank: replicated for ``spec=()``, else each leaf cut to
    this rank's block along the dimension ``spec`` names an axis at (JAX
    ``put_global``)."""
    leaves: List[torch.Tensor] = []

    def collect(x):
        if torch.is_tensor(x):
            leaves.append(x.detach().clone())
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(tree)
    device = _comm_device(mesh)
    _broadcast(leaves, device)
    d = _sharded_dim(tuple(spec))
    if d is not None:
        parts = axis_size(mesh, spec[d])
        index = int(mesh.get_coordinate()[tuple(mesh.mesh_dim_names).index(spec[d])])
        leaves = [_local_shard(t, d, parts, index) for t in leaves]
    it = iter(leaves)

    def rebuild(x):
        if torch.is_tensor(x):
            return next(it)
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)
