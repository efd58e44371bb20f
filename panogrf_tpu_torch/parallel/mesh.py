"""A mesh of ranks and its collectives.

Port of ``panogrf_tpu/parallel/mesh.py``.  The JAX package drives N
devices from one process through a ``jax.sharding.Mesh``; the port runs one
process per rank (``parallel/launch.run_ranks``), and a :class:`Mesh` is
one rank's view of them: the world size and its ``(data, ray)`` shape,
this rank and its device, and the process group of each axis.
"Replicated" means that every rank holds the same tensor.

The collectives use ``all_reduce`` and ``broadcast`` alone (gloo, which
runs several ranks on one card and the CPU tests, has no ``all_gather``
for CUDA tensors) and are ``torch.autograd.Function``s:

* :func:`psum` all-reduces over an axis and its backward all-reduces the
  gradient (JAX's transpose of ``psum``, which ``pmean`` under
  ``shard_map`` relies on); :func:`pmean` divides it by the axis size;
* :func:`assemble` writes this rank's slice into a zero-filled full tensor
  and all-reduces it; its backward all-reduces the gradient and keeps the
  rank's slice (the transpose of an all-gather).

Nothing here is global: a module that communicates is handed the mesh.
The BatchNorms given a ``bn_axis`` and a mesh (``nn/blocks.set_bn_axis``)
take their statistics over that axis; the training steps
(``train/trainer.make_train_step``, ``train/depth_trainer.DepthTrainer``)
take a ``mesh`` and split their batch with :func:`shard_ray_batch` or
:func:`place_depth_batch` and sum their gradients with :func:`sync_grads`;
``renderer/full_render`` renders a rank's share of a frame's rays.  This
module imports nothing of the port, so those layers may import it; the
rest of ``parallel/`` imports them, never the reverse.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable

import torch
import torch.distributed as dist

DATA_AXIS = "data"
RAY_AXIS = "ray"
# an axis of one rank in a world of several: nothing to communicate
_LOCAL = "local"


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA ranks (one card each), gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def check_world(n: int, device, backend: str | None = None) -> None:
    """Refuse ``n`` ranks that ``backend`` cannot place on ``device``:
    under NCCL each rank needs a CUDA device of its own."""
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    if n < 1:
        raise ValueError(f"a mesh needs at least 1 rank, got {n}")
    if backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(
            f"a mesh of {n} ranks needs {n} CUDA devices (one per rank under "
            f"NCCL) but torch.cuda.device_count() is "
            f"{torch.cuda.device_count()}; several ranks share one card only "
            f"with backend='gloo'")


class Mesh:
    """This rank's view of an ``(data, ray)`` mesh of ``size`` ranks; rank
    ``r`` sits at data index ``r // ray`` and ray index ``r % ray``."""

    def __init__(self, rank: int, size: int, data: int,
                 device: torch.device, groups: dict,
                 distributed: bool):
        self.rank, self.size, self.device = rank, size, device
        self.shape = {DATA_AXIS: data, RAY_AXIS: size // data}
        self.distributed = distributed
        self._groups = groups

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, shape={self.shape}, "
                f"device={self.device})")

    def axis_index(self, axis: str) -> int:
        ray = self.shape[RAY_AXIS]
        return self.rank // ray if axis == DATA_AXIS else self.rank % ray

    def group(self, axis: str):
        """The process group over ``axis`` (None: the world), or
        ``_LOCAL`` when the axis holds this rank alone."""
        return self._groups[axis]


def make_mesh(n_devices: int | None = None, data: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """This rank's mesh over ``n_devices`` ranks, shaped (data, ray): all
    on the data axis (``data=n``) or all on the ray axis (``data=1``); the
    port's paths split one axis, and a 2-D mesh is refused.

    Inside ``run_ranks`` (an initialised process group) the mesh spans its
    world, on the device the launcher gave this rank; elsewhere only a
    world of 1 exists, whose collectives do nothing.
    """
    dev = torch.device(device)
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    else:
        size, rank, backend = 1, 0, None
    n = n_devices or size
    check_world(n, dev, backend)
    if n != size:
        raise ValueError(
            f"make_mesh({n}) in a world of {size} rank(s): build a mesh of "
            f"{n} on every rank of parallel.launch.run_ranks(fn, {n}, ...)")
    if data not in (1, n):
        raise ValueError(f"make_mesh({n}, data={data}): the data axis holds "
                         f"1 or all {n} ranks (a 2-D mesh is not ported)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    distributed = dist.is_initialized()
    # the axis that holds every rank reduces over the world (None), the
    # other holds this rank alone
    groups = {axis: None if distributed and k == n else _LOCAL
              for axis, k in ((DATA_AXIS, data), (RAY_AXIS, n // data))}
    return Mesh(rank, n, data, dev, groups, distributed)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, count, group):
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * count
        full = x.new_zeros(shape)
        full.narrow(dim, index * n, n).copy_(x)
        dist.all_reduce(full, group=group)
        ctx.args = (dim, index * n, n, group)
        return full

    @staticmethod
    def backward(ctx, g):
        dim, start, n, group = ctx.args
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=group)
        return g.narrow(dim, start, n), None, None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``; its gradient is summed over
    them too."""
    group = mesh.group(axis)
    return x if group is _LOCAL else _AllReduce.apply(x, group)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axis`` (``psum`` / size)."""
    return psum(x, mesh, axis) / mesh.shape[axis]


def assemble(x: torch.Tensor, mesh: Mesh, axis: str,
             dim: int = 0) -> torch.Tensor:
    """The full tensor whose ``dim`` is the ranks' slices of ``axis`` in
    index order, each as long as ``x``'s; replicated over the axis."""
    group = mesh.group(axis)
    if group is _LOCAL:
        return x
    return _Assemble.apply(x, dim, mesh.axis_index(axis),
                           mesh.shape[axis], group)


def broadcast_(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``x`` in place with rank ``src``'s ``x`` (every rank)."""
    if mesh.distributed:
        dist.broadcast(x, src)
    return x


def broadcast_object(obj, mesh: Mesh, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (pickled by this
    program on ``src``, so unpickling it is safe)."""
    if not mesh.distributed:
        return obj
    payload = pickle.dumps(obj) if mesh.rank == src else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(size, src)
    buf = torch.zeros(int(size), dtype=torch.uint8, device=mesh.device)
    if mesh.rank == src:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, src)
    return obj if mesh.rank == src else pickle.loads(buf.cpu().numpy()
                                                     .tobytes())


def gather_counts(count: int, mesh: Mesh) -> list:
    """Every rank's ``count``, in rank order (on every rank)."""
    v = torch.zeros(mesh.size, dtype=torch.float64, device=mesh.device)
    v[mesh.rank] = count
    if mesh.distributed:
        dist.all_reduce(v)
    return [int(c) for c in v.tolist()]


def _map_leaves(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _take(leaf: torch.Tensor, dim: int, n: int, i: int, what: str,
          axis: str) -> torch.Tensor:
    size = leaf.shape[dim]
    if size % n:
        raise ValueError(
            f"batch leaf {what} has dim {dim} of {size}, not divisible by "
            f"the {n}-way '{axis}' mesh axis — use a batch size that is a "
            f"multiple of the mesh size")
    k = size // n
    return leaf.narrow(dim, i * k, k)


def shard_ray_batch(mesh: Mesh, data: dict) -> dict:
    """This rank's slice of the ray axis (dim 1) of every per-ray leaf of a
    renderer ``data`` dict (any leaf under a ``coords`` key) over the
    mesh's ray axis; the other leaves are replicated as they are."""
    n, i = mesh.shape[RAY_AXIS], mesh.axis_index(RAY_AXIS)

    def place(path, leaf):
        if "coords" in path:
            return _take(leaf, 1, n, i, "/".join(map(str, path)), RAY_AXIS)
        return leaf
    return _map_leaves(place, data)


def place_depth_batch(mesh: Mesh, batch: dict,
                      axis: str = DATA_AXIS) -> dict:
    """This rank's slice of the leading (batch) dimension of every leaf of
    a depth batch, over the mesh's ``axis``; the dimensions must divide by
    the axis size."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)
    return _map_leaves(lambda path, leaf: _take(leaf, 0, n, i, "/".join(
        map(str, path)), axis), batch)


def replicate_tree(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank, in place; returns
    ``module``."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            broadcast_(t.data, mesh)
    return module


def sync_grads(params, mesh: Mesh, axis: str, mean: bool) -> None:
    """Sum (``mean``: average) the parameters' ``.grad`` over ``axis``'s
    ranks in place, in one all-reduce."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or mesh.group(axis) is _LOCAL:
        return
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
    if mean:
        flat = flat / mesh.shape[axis]
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
