"""Run a function on N ranks, one process each.

The JAX package needs no launcher: one process drives every device of its
mesh.  The port runs a process per rank.  ``run_ranks`` spawns them with
``torch.multiprocessing`` (start method ``spawn``); they join one process
group through a ``FileStore`` in a temporary directory, so no port is
opened.  The backend follows the device: NCCL with rank r on ``cuda:r``,
gloo on the CPU.  A caller may name ``backend="gloo"`` to run several
ranks on the cards there are (``chip_smoke.py`` runs two on one card).  A
world of 1 runs in the calling process, in a group of its own.

Every group has time limits: each collective's (``init_process_group``'s
``timeout``), so a stuck collective fails, and optionally a deadline on
the whole run, past which the ranks are killed.  Each rank takes the
caller's TF32 and cuDNN settings (a fresh process would run cuDNN's
convolutions in TF32 where the caller may not).  ``fn`` and its ``args``
are pickled (``fn`` by its import path: it lives in a module of the port,
not in a script or a test file).  The first rank to fail ends the run
with its traceback; rank 0's result is returned.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from panogrf_tpu_torch.parallel.mesh import check_world, default_backend
from panogrf_tpu_torch.utils.device import resolve_device

COLLECTIVE_TIMEOUT_S = 600.0


def _join(rank: int, n: int, store_path: str, backend: str,
          device: torch.device, timeout_s: float) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, n), rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s))


def _numerics() -> dict:
    """The caller's float32 settings that a fresh process would not share:
    TF32 in matmuls and convolutions, cuDNN's algorithm choice."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic}


def _rank_main(rank, n, store_path, backend, device, timeout_s, threads,
               numerics, fn, args, results) -> None:
    try:
        if rank:
            sys.stdout = open(os.devnull, "w")
        if threads:
            torch.set_num_threads(threads)
        torch.backends.cuda.matmul.allow_tf32 = numerics["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = numerics["cudnn_tf32"]
        torch.backends.cudnn.benchmark = numerics["cudnn_benchmark"]
        torch.backends.cudnn.deterministic = numerics["cudnn_deterministic"]
        _join(rank, n, store_path, backend, device, timeout_s)
        out = fn(*args)
        dist.destroy_process_group()
        results.put((rank, None, out if rank == 0 else None))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(fn, n: int, device: str | torch.device = "cuda",
              args: tuple = (), backend: str | None = None,
              timeout_s: float = COLLECTIVE_TIMEOUT_S,
              deadline_s: float | None = None):
    """``fn(*args)`` on each of ``n`` ranks; returns rank 0's result.

    :param device: the ranks' device type, ``"cuda"`` (rank r on card
        ``r % device_count``) or ``"cpu"``; the kernels are built here
        first, so the ranks do not race on the build.
    :param backend: default NCCL on CUDA, gloo on the CPU.
    :param timeout_s: the time limit of each collective.
    :param deadline_s: optional limit on the whole run; past it every rank
        is killed and ``TimeoutError`` raised.
    """
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    check_world(n, dev, backend)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        from panogrf_tpu_torch.ops.kernels import _build
        _build.load_library()
    with tempfile.TemporaryDirectory(prefix="panogrf_ranks_") as tmp:
        store_path = os.path.join(tmp, "store")
        if n == 1:
            _join(0, 1, store_path, backend, dev, timeout_s)
            try:
                return fn(*args)
            finally:
                dist.destroy_process_group()
        # ranks on the CPU share its cores
        threads = max(1, torch.get_num_threads() // n) \
            if dev.type == "cpu" else None
        ctx = mp.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            r, n, store_path, backend, dev, timeout_s, threads, _numerics(),
            fn, args, results)) for r in range(n)]
        for p in procs:
            p.start()
        done = False
        try:
            out = _collect(procs, results, deadline_s)
            done = True
            return out
        finally:
            # after a failure the other ranks may wait in a collective
            for p in procs:
                if done:
                    p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                p.join(timeout=5)


def _collect(procs: list, results, deadline_s: float | None):
    """Rank 0's result once every rank has reported; raise on the first
    failure, on a rank that died without reporting, or at the deadline."""
    n = len(procs)
    end = None if deadline_s is None else time.monotonic() + deadline_s
    reported, out = set(), None
    while len(reported) < n:
        if end is not None and time.monotonic() > end:
            raise TimeoutError(f"{n} ranks did not finish within "
                               f"{deadline_s} s; killed")
        try:
            rank, err, value = results.get(timeout=1.0)
        except queue_mod.Empty:
            dead = [r for r, p in enumerate(procs) if r not in reported
                    and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} without a "
                                   f"result")
            continue
        if err is not None:
            raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
        reported.add(rank)
        if rank == 0:
            out = value
    return out
