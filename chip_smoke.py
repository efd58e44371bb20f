"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``panogrf_tpu_torch/csrc`` (ptxas must report
no stack frame and no spills for the specialised variants), holds every
variant of each kernel (``mlp2``: ``lanes``, ``generic``; ``mlp3``:
``mma``, ``rows``, ``generic``) and each kernel's autograd Function
against its plain PyTorch version on the card, times each kernel at its
path shapes beside ``generic``, the plain version, a read pass, a copy and
the wrapper's host cost, then drives the port's two paths at full width
(every ``mlp2`` launch there must take ``lanes``):

* serving: 512x1024 frames (``serving`` and ``turbo`` at their 256-ray
  chunk, then ``serving`` at 4096-ray chunks), with profiles of fine-pass
  chunks of both sizes, and the CUDA path against the CPU path at 64x128;
* training: the training CLI on the 2-view 512x1024 recipe (1 warm-up and
  5 timed Adam steps, with a profile of one more step), and one training
  step on CUDA against the same step on the CPU at 64x128;
* the depth stack: UniFuse + the 360-degree MVS net at full width on the
  2 reference views of a 512x1024 scene (ms per scene, peak memory,
  operations, a profile), and the small stack on CUDA against the CPU;
* depth training: the ``train_mono`` CLI on the mono recipe at 512x1024
  and the ``train_depth`` CLI on ``configs/depth/m3d_mvs.yaml`` from the
  mono run's checkpoint (1 warm-up and 5 timed Adam steps each, every
  parameter and BatchNorm statistic moved, no MLP kernel launched), a
  profile of one MVS step, one small step of each recipe on CUDA against
  the CPU, and ``eval_depth`` on the two checkpoints;
* the composed pipeline: the render CLI at 512x1024 from the stack's
  depth (its MVS net from the depth-training checkpoint), an eval frame
  with its metrics and a 4-pose path at frame batches of 2 and 1, and a
  3-pose video group against its frames on the card at 64x128;
* multi-view training and finetuning: the training CLI on the V = 4
  recipe with and without the consistency loss, the ``train_ft`` CLI with
  depth guidance from the 2-view checkpoint (6 steps each, the latter two
  profiled), ``render_ft`` and ``render_mv`` frames at 512x1024, and a
  consistency step and an ft step at 64x128 on CUDA against the CPU;
* the renderer's other modes: 512x1024 DINER frames (bench.py's
  ``--diner`` setup, 128 candidates, then with a 64-sample uniform pass
  merged) and a light-coarse frame with a profile of DINER chunks, the
  ``render_cubes`` CLI (six 256x256 cube faces), the ``ab_quality`` CLI
  (6 DINER training steps, then its DINER modes), and DINER,
  light-coarse, cube-face, nearest-gather and vis-head frames and a DINER
  training step at 64x128 on CUDA against the CPU;
* the depth-net variants: the ``train_mono`` CLI with the ERP+TP mono net
  and on MobileNetV2 at 512x1024, the ``train_depth`` CLI on
  ``configs/depth/m3d_mvs.yaml`` with CostRegNet and with FNET (6 steps
  each), one MVS forward with each feature net and ``with_sin``, a
  512x1024 frame with the renderer's ERP+TP encoders, a small step of each
  variant and a 64x128 ERP+TP frame on CUDA against the CPU, and the mono
  recipe's cube-encoder gradients on CUDA and the CPU against float64;
* the data pipeline: ``prepare_data`` writing 512x1024 shards on the card
  (three-view, and with cube faces), an LMDB env imported through
  ``import_lmdb``, the shard reader's host ms per sample on 4 shards of
  64 samples, the training CLI and ``train_mono`` on those shards and
  ``train_depth`` on 256x512 shards (6 steps each),
  ``render --shards`` eval frames and ``render_cubes --shards`` faces
  against the stored faces, and the online generator, the readers'
  resize and the augmentations on CUDA against the CPU at 64x128;
* multi-GPU: ``--mesh 1`` (NCCL, one rank) through ``train_mono``,
  ``train_depth``, ``train_renderer`` (3 steps each) and ``render`` (an
  eval frame) at full width against the same CLIs without ``--mesh``, then
  the sharded depth step, the sharded renderer step and the sharded
  serving frame of ``panogrf_tpu_torch/parallel/programs.py`` on 2 ranks
  sharing the card (gloo, CUDA tensors) against 1 rank, with ms/step and
  ms/frame per world size and the ``mlp2`` launches per rank;
* the measurement and evaluation tools: ``tools.bench`` at 512x1024 (4096-
  ray chunks with the stage roofline, a B = 2 video pass, the depth
  stack, the ``agg`` / ``gather`` / ``attn`` ablations, DINER, and its
  default run: serving at 256-ray chunks and turbo), the merged-map row
  fetch's ns per row in depth-major and scattered order at two chunks
  (why the roofline has no ``GATHER_NS_PER_ROW``), ``tools.bench_train``
  on both recipes, LPIPS at
  512x1024 and on the card against the CPU at 64x128,
  ``tools.parity_check`` on the training groups' files (the composed
  exact render, with LPIPS) and ``tools.eval_dirs`` on the render CLI's
  eval frame.

Each path checks that it went through its kernels.  Each phase prints one
JSON line; any failure raises, so the process exits non-zero.  The last
three lines are the card's name and power limit, the kernel table and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository, it fails before printing a result.
``--phases`` runs a subset of the phase groups (then it prints no
result and exits 2).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.data import augment, imgs_info, lmdb_import
from panogrf_tpu_torch.data import lmdb_reader, readers
from panogrf_tpu_torch.data import shards as shards_mod
from panogrf_tpu_torch.data.database import PanoDatabase
from panogrf_tpu_torch.data.online import OnlineImageGenerator
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_multi_view_sample,
                                              make_three_view_sample)
from panogrf_tpu_torch.models import depth_stack
from panogrf_tpu_torch.models import fnet as tfnet
from panogrf_tpu_torch.models import mvs as tmvs
from panogrf_tpu_torch.models import unifuse as tunifuse
from panogrf_tpu_torch.nn import blocks as tblocks
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.ops.kernels import _build, fused_mlp
from panogrf_tpu_torch.parallel import programs
from panogrf_tpu_torch.parallel.launch import run_ranks
from panogrf_tpu_torch.renderer import diner as diner_mod
from panogrf_tpu_torch.renderer import full_render, render_ops
from panogrf_tpu_torch.renderer.presets import (PRESET_CHUNK,
                                                PRESET_COARSE_LOWRES,
                                                preset_kwargs)
from panogrf_tpu_torch.renderer.ft_renderer import (NeuralRayFtRenderer,
                                                    ft_depth_range_at_coords,
                                                    init_ft_params_from_gen)
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools import (bench, bench_train, eval_dirs,
                                     parity_check)
from panogrf_tpu_torch.tools import eval_depth, train_depth, train_mono
from panogrf_tpu_torch.tools import render as render_tool
from panogrf_tpu_torch.tools import (ab_quality, import_lmdb, prepare_data,
                                     render_cubes, render_ft, render_mv,
                                     train_ft, train_renderer)
from panogrf_tpu_torch.train import depth_trainer
from panogrf_tpu_torch.train import lpips as tlpips
from panogrf_tpu_torch.train import trainer as trainer_mod

H, W, DH, DW, RFN = 512, 1024, 256, 512, 2
TRAIN_CFG = "configs/gen/neuray_gen_cv_erp_mono_stereo_uniform_512x1024.yaml"
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_kernels(log: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    nvcc's ``-Xptxas=-v`` output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([\w$]+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def build() -> None:
    """Build (or reuse) the kernels' library; print what ptxas reports for
    each kernel.  The redesigned variants (``*_lanes_kernel``,
    ``*_rows_kernel``, ``*_mma_kernel``) must have no stack frame and no
    spills."""
    _build.load_library()
    info = _build.BUILD_INFO
    kernels = ptxas_kernels(info["log"])
    emit({"phase": "build", "seconds": info["seconds"],
          "sources": info["sources"], "reused": not info["log"],
          "ptxas": kernels})
    new = {k: v for k, v in kernels.items()
           if re.search("(lanes|rows|mma)_kernel", k)}
    if info["log"] and len(new) < 4:
        raise AssertionError(f"ptxas reported {len(new)} redesigned kernels")
    for k, v in new.items():
        if v.get("stack") or v.get("spill_stores") or v.get("spill_loads"):
            raise AssertionError(f"{k}: stack frame or spills {v}")


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def event_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time per call over ``iters`` back-to-back calls, timed
    with CUDA events.  A spin kernel holds the stream first, so the host
    has queued every call before the device reaches the start event and
    the events see device time, not the host's cost of issuing calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # ~50 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cuda_kernel_rows(prof) -> list:
    """(name, device us, count) of each GPU kernel; ranges such as
    ``Optimizer.step#Adam.step`` span kernels already counted."""
    return [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def profiler_time_us(fn, iters: int = 50) -> float | None:
    """Mean device time per call as torch.profiler sums it: the duration
    of the GPU kernels one call launches, without the gaps between them;
    None when the profiler recorded no kernel (not a time of 0)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = _cuda_kernel_rows(prof)
    return sum(r[1] for r in rows) / iters if rows else None


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def mlp_inputs(n, dims, dtype, seed, offset=0):
    """x (n, dims[0]) and W, b of each layer of widths ``dims``, seeded; x
    is a view ``offset`` elements into its storage (1: not 16-byte
    aligned)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n * dims[0] + offset, generator=g)
    out = [x.to("cuda", dtype)[offset:].view(n, dims[0])]
    for a, b in zip(dims[:-1], dims[1:]):
        out += [(torch.randn((a, b), generator=g) * a ** -0.5).to("cuda", dtype),
                (torch.randn((b,), generator=g) * 0.1).to("cuda", dtype)]
    return out


def mlp_bound_ms(n, dims, dtype) -> tuple:
    """(least time in ms, what bounds it) of an MLP over n rows: each input
    read once and the output written once at the HBM rate, against the
    matmul operations at the dtype's peak rate."""
    elt = torch.finfo(dtype).bits // 8
    weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = elt * (n * (dims[0] + dims[-1]) + weights)
    flops = 2 * n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def call_mlp(name, args, acts, plain=False):
    """``mlp2``/``mlp3`` (or its plain version) on ``args`` = [x, W1, b1,
    ...]."""
    fn = getattr(fused_mlp, name + ("_plain" if plain else ""))
    return fn(*args, *acts) if name == "mlp2" else fn(*args, acts)


F32, BF16 = torch.float32, torch.bfloat16
# (label, rows, widths, activations, x's storage offset, expected variant
# in float32 and in bfloat16): the path widths, ragged and tiny row counts,
# a misaligned x and the wide cases; mlp2's ``modes`` rows (4096 rays x 64
# samples, a launch of the DINER / light-coarse frames and cube faces) are
# more tiles than the ``lanes`` grid holds, so its blocks take several
# grid-stride passes
MLP_CASES = {
    "mlp2": [(lbl, n, (16, 16, 1), ("elu", "relu"), off, {F32: v, BF16: v})
             for lbl, n, off, v in [("path", 16384, 0, "lanes"),
                                    ("ragged", 16381, 0, "lanes"),
                                    ("modes", 262144, 0, "lanes"),
                                    ("modes_ragged", 262139, 0, "lanes"),
                                    ("n1", 1, 0, "lanes"),
                                    ("n17", 17, 0, "lanes"),
                                    ("misaligned", 16384, 1, "generic")]]
    + [("wide", 16384, (35, 64, 32), ("elu", "elu"), 0,
        {F32: "generic", BF16: "generic"})],
    "mlp3": [(lbl, n, (32, 32, 32, 2), acts, off, want)
             for lbl, n, acts, off, want in [
                 ("path", 65536, ("elu", "elu", "softplus"), 0,
                  {F32: "rows", BF16: "mma"}),
                 ("ragged", 65533, ("elu", "elu", "sigmoid"), 0,
                  {F32: "rows", BF16: "mma"}),
                 ("n1", 1, ("elu", "relu", "softplus"), 0,
                  {F32: "rows", BF16: "mma"}),
                 ("n17", 17, ("relu", "elu", "none"), 0,
                  {F32: "rows", BF16: "mma"}),
                 ("misaligned", 65536, ("elu", "elu", "softplus"), 1,
                  {F32: "generic", BF16: "generic"})]]
    + [("dout1", 65533, (32, 32, 32, 1), ("elu", "elu", "sigmoid"), 0,
        {F32: "generic", BF16: "generic"}),
       ("wide", 16384, (35, 64, 64, 32), ("elu", "elu", "none"), 0,
        {F32: "generic", BF16: "generic"})],
}


def check_kernel(name: str) -> dict:
    """Every case of ``MLP_CASES[name]`` against the plain version on the
    card: float32 within 1e-5 of the output scale, bfloat16 within 2e-2
    (the plain version rounds each layer's output to bfloat16).  Each case
    must launch the expected variant once.  Returns the largest errors."""
    errs = {F32: 0.0, BF16: 0.0}
    rels = {F32: 0.0, BF16: 0.0}
    for dtype, rel in ((F32, 1e-5), (BF16, 2e-2)):
        for i, (label, n, dims, acts, off, want) in enumerate(MLP_CASES[name]):
            args = mlp_inputs(n, dims, dtype, seed=i + 20 * (name == "mlp3"),
                              offset=off)
            before = dict(fused_mlp.VARIANT_LAUNCHES)
            got = call_mlp(name, args, acts)
            ran = {k: v - before[k] for k, v in
                   fused_mlp.VARIANT_LAUNCHES.items() if v != before[k]}
            want_plain = call_mlp(name, args, acts, plain=True)
            torch.cuda.synchronize()
            err = (got.float() - want_plain.float()).abs().max().item()
            scale = max(1.0, want_plain.float().abs().max().item())
            emit({"phase": "kernel_check", "kernel": name, "case": label,
                  "dtype": str(dtype), "shape": [n, *dims], "acts": acts,
                  "x_offset": off, "variant": list(ran), "max_abs_err": err,
                  "scale": scale})
            if ran != {f"{name}_{want[dtype]}": 1}:
                raise AssertionError(f"{name} {label} {dtype}: launched {ran}"
                                     f", expected {want[dtype]}")
            if not err <= rel * scale:
                raise AssertionError(f"{name} {label} {dtype} {n}x{dims}: "
                                     f"error {err} > {rel} x {scale}")
            errs[dtype] = max(errs[dtype], err)
            rels[dtype] = max(rels[dtype], err / scale)
    return {"max_abs_err": max(errs.values()),
            "max_err_fp32": errs[F32], "max_err_bf16": errs[BF16],
            "max_rel_err_fp32": rels[F32], "max_rel_err_bf16": rels[BF16]}


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Median host time of one call under inference mode, no
    synchronisation inside the loop."""
    times = []
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def time_kernel(name, n, dims, acts, dtype, seed) -> dict:
    """At one shape: the kernel through its wrapper (the chosen variant),
    the ``generic`` variant (``previous``), the plain version and a read
    pass (``torch.sum(x, -1)``: reads x, writes one value per row), each
    by CUDA events and by the profiler, and a copy of x by events
    (``x.clone()``: reads and writes x once, a floor that ``torch.sum``
    misses at narrow rows); kernel and generic in two turns
    (kernel, generic, kernel, generic); the wrapper's host cost."""
    args = mlp_inputs(n, dims, dtype, seed)
    x, layers = args[0], list(zip(args[1::2], args[2::2]))
    variant = fused_mlp.choose_variant(name, dims, dtype, x.data_ptr())
    fns = {"kernel": lambda: call_mlp(name, args, acts),
           "previous": lambda: fused_mlp._launch(name, x, layers, acts,
                                                 "generic"),
           "plain": lambda: call_mlp(name, args, acts, plain=True),
           "read_pass": lambda: torch.sum(x, -1),
           "copy": lambda: x.clone()}
    runs = {k: [] for k in fns}
    for turn in range(2):
        for k in ("kernel", "previous"):
            runs[k].append(event_time_ms(fns[k], 200) * 1e3)
    # the plain version launches ~10-20 kernels a call: 50 calls stay
    # inside the device's queue of pending launches
    runs["plain"].append(event_time_ms(fns["plain"], 50) * 1e3)
    for k in ("read_pass", "copy"):
        runs[k].append(event_time_ms(fns[k], 200) * 1e3)
    us = {k: statistics.mean(v) for k, v in runs.items()}
    prof = {k: profiler_time_us(fns[k])
            for k in ("kernel", "previous", "plain", "read_pass")}
    bound, bound_by, nbytes, flops = mlp_bound_ms(n, dims, dtype)
    row = {"shape": [n, *dims], "acts": list(acts),
           "dtype": str(dtype).replace("torch.", ""), "variant": variant,
           "us": us["kernel"], "profiler_us": prof["kernel"],
           "previous_us": us["previous"],
           "previous_profiler_us": prof["previous"],
           "plain_us": us["plain"], "plain_profiler_us": prof["plain"],
           "read_pass_us": us["read_pass"],
           "read_pass_profiler_us": prof["read_pass"],
           "copy_us": us["copy"],
           "host_us_per_call": host_us_per_call(fns["kernel"]),
           "bound_us": bound * 1e3, "bound_by": bound_by,
           "bound_bytes": nbytes, "bound_flops": flops, "runs_us": runs}
    emit({"phase": "kernel_time", "kernel": name, **row})
    return row


# the shapes each kernel is timed at: mlp2 at the serving (bfloat16) and
# training (float32) out_geometry_fc, mlp3 at the dist-decoder head shape
MLP3_HEAD = (65536, (32, 32, 32, 2), ("elu", "elu", "softplus"))
TIMED = {"mlp2": [(16384, (16, 16, 1), ("elu", "relu"), BF16),
                  (32768, (16, 16, 1), ("elu", "relu"), F32)],
         "mlp3": [(*MLP3_HEAD, BF16), (*MLP3_HEAD, F32)]}
REPLACES = {"mlp2": "panogrf_tpu/ops/pallas/fused_mlp.py:51",
            "mlp3": "panogrf_tpu/ops/pallas/fused_mlp.py:146"}


def us_to_ms(us: float | None) -> float | None:
    return None if us is None else us / 1e3


def check_and_time(name: str) -> dict:
    """``check_kernel``, then ``time_kernel`` at each timed shape; the
    kernel-table row of ``name``, its main numbers from the first shape.
    Each redesigned variant must beat ``generic`` at its shapes, and
    ``mlp3``'s bfloat16 kernel must be no slower than its plain version.
    ``launches`` is filled in from the main paths by ``main``."""
    errs = check_kernel(name)
    times = [time_kernel(name, *case, seed=9 + k)
             for k, case in enumerate(TIMED[name])]
    for t in times:
        if not t["us"] < t["previous_us"]:
            raise AssertionError(f"{name} {t['variant']} {t['dtype']}: "
                                 f"{t['us']} us, generic {t['previous_us']}")
    if name == "mlp3" and not times[0]["us"] <= times[0]["plain_us"]:
        raise AssertionError(f"mlp3 bf16: {times[0]['us']} us, plain "
                             f"{times[0]['plain_us']}")
    t = times[0]
    return {"name": name, "route": "cuda",
            "source": "panogrf_tpu_torch/csrc/fused_mlp.cu",
            "replaces": REPLACES[name], "launches": None, **errs,
            "ms": t["us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
            "library_ms": None, "variant": t["variant"],
            "previous_us": t["previous_us"], "read_pass_us": t["read_pass_us"],
            "host_us_per_call": t["host_us_per_call"],
            "kernel_us": t["us"], "plain_us": t["plain_us"],
            "bound_us": t["bound_us"],
            "profiler_ms": us_to_ms(t["profiler_us"]),
            "plain_profiler_ms": us_to_ms(t["plain_profiler_us"]),
            "shape": t["shape"], "dtype": t["dtype"],
            "times": [{k: v for k, v in r.items() if k != "runs_us"}
                      for r in times]}


def grad_check() -> None:
    """_Mlp2Fn and _Mlp3Fn on CUDA (kernel forward, backward through the
    plain version) against autograd through the plain versions on CUDA,
    float32: the output and the gradients of x and of every weight and
    bias within 1e-4 of each one's scale.  Each forward must launch its
    kernel once."""
    cases = [("mlp2", 32768, (16, 16, 1), ("elu", "relu")), ("mlp3", *MLP3_HEAD)]
    for name, n, dims, acts in cases:
        kernel = getattr(fused_mlp, name)
        plain = getattr(fused_mlp, name + "_plain")
        config = acts if name == "mlp2" else (acts,)
        args = mlp_inputs(n, dims, torch.float32, seed=40)
        g = torch.randn(n, dims[-1], generator=torch.Generator()
                        .manual_seed(41)).cuda()
        results = []
        for fn in (kernel, plain):
            xs = [a.clone().requires_grad_(True) for a in args]
            before = (fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES)
            out = fn(*xs, *config)
            launched = (fused_mlp.MLP2_LAUNCHES - before[0],
                        fused_mlp.MLP3_LAUNCHES - before[1])
            out.backward(g)
            results.append((out.detach(), [x.grad for x in xs], launched))
        (out_k, grads_k, launched), (out_p, grads_p, _) = results
        want_launched = (1, 0) if name == "mlp2" else (0, 1)
        errs = []
        for a, b in zip([out_k] + grads_k, [out_p] + grads_p):
            errs.append([(a - b).abs().max().item(),
                         max(b.abs().max().item(), 1e-30)])
        emit({"phase": "grad_check", "kernel": name, "shape": [n, *dims],
              "acts": list(acts), "dtype": "float32",
              "kernel_launches": launched[want_launched.index(1)],
              "max_abs_err_out": errs[0][0],
              "max_abs_err_grads": [e for e, _ in errs[1:]],
              "grad_scales": [sc for _, sc in errs[1:]]})
        if launched != want_launched:
            raise AssertionError(f"{name}: forward launched {launched}")
        for (err, scale), what in zip(errs, ["out", "x", "w1", "b1", "w2",
                                             "b2", "w3", "b3"]):
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{name} grad_check {what}: error {err}"
                                     f" > 1e-4 x {scale}")


def assert_specialised(what: str, mlp2_launches: int, variants: dict) -> None:
    """Every ``mlp2`` launch of a main-path run went to the specialised
    variant (``lanes``), none to ``generic``."""
    if variants["mlp2_lanes"] != mlp2_launches or variants["mlp2_generic"]:
        raise AssertionError(f"{what}: mlp2 variants {variants}, "
                             f"{mlp2_launches} launches")


# ---------------------------------------------------------------------------
# the serving render
# ---------------------------------------------------------------------------

def frame_run(phase: str, run: str, frame, expected: int, meta: dict,
              like: torch.Tensor | None = None) -> tuple:
    """One frame ``frame()`` counted (its mlp2 launches must equal
    ``expected``, all ``lanes``, and no mlp3) then three CUDA-event timed
    runs; checks the frame is (H, W, 3), finite, in [0, 1], and reports
    its difference from ``like`` (the same frame at another chunk, whose
    bfloat16 products may round differently).  Emits the phase's line and
    returns it with the frame."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.reset_launches()
    t0 = time.perf_counter()
    rgb = frame()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    count, count3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
    variants = dict(fused_mlp.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    runs, host_ms = [], []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        frame()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        runs.append(start.elapsed_time(end))
    row = {"phase": phase, "run": run, "hw": list(rgb.shape[:2]), **meta,
           "mlp2_launches": count, "mlp3_launches": count3,
           "variant_launches": variants,
           "ms_per_frame": statistics.median(runs),
           "ms_per_frame_runs": runs, "host_ms_runs": host_ms,
           "first_frame_ms": first_ms, "peak_mem_bytes": peak,
           "rgb_mean": rgb.mean().item(), "rgb_std": rgb.std().item()}
    if like is not None:
        diff = (rgb - like).abs()
        row["max_abs_diff_vs_preset_chunk"] = diff.max().item()
        row["mean_abs_diff_vs_preset_chunk"] = diff.mean().item()
    emit(row)
    if tuple(rgb.shape) != (H, W, 3) or not torch.isfinite(rgb).all() \
            or rgb.min() < 0 or rgb.max() > 1:
        raise AssertionError(f"{phase} {run}: bad frame {tuple(rgb.shape)}")
    if count != expected or count3:
        raise AssertionError(f"{phase} {run}: mlp2 launched {count} times, "
                             f"expected {expected}; mlp3 {count3}")
    assert_specialised(f"{phase} {run}", count, variants)
    return row, rgb


def render_full_width() -> tuple:
    """The serving frames at 512x1024; returns ({preset: mlp2 launches of
    its first frame}, mlp3 launches over the frames' first runs)."""
    model = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW), **preset_kwargs("serving"),
        device="cuda", generator=torch.Generator().manual_seed(0))
    ref_info, c2w, qdr = bench.bench_inputs(H, W, DH, DW)
    t0 = time.perf_counter()
    ref = full_render.prepare_ref_data(model, ref_info)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    launches, first_rgb, mlp3_launches = {}, {}, 0
    # the presets at their chunk, then serving at a 16x larger chunk
    # (chunking is pure blocking: fewer, larger launches of the same work)
    runs = [("serving", PRESET_CHUNK["serving"]),
            ("turbo", PRESET_CHUNK["turbo"]), ("serving", 4096)]
    for preset, chunk in runs:
        f = PRESET_COARSE_LOWRES[preset]
        # one mlp2 launch per chunk of the fine pass and of the coarse pass
        expected = H * W // chunk + (H // f) * (W // f) // chunk
        row, rgb = frame_run(
            "frame", preset, lambda: full_render.render_image_device(
                model, ref, c2w, qdr, ref_info["depth_range"], chunk=chunk,
                coarse_lowres=f), expected,
            {"preset": preset, "depth_hw": [DH, DW], "samples": [64, 64],
             "chunk": chunk, "coarse_lowres": f, "dtype": "bfloat16",
             "prepare_ref_ms": prep_ms},
            like=first_rgb.get(preset))
        mlp3_launches += row["mlp3_launches"]
        launches.setdefault(preset, row["mlp2_launches"])
        first_rgb.setdefault(preset, rgb)
    c2w_t, qdr_t, dr_t = cuda_f32(c2w, qdr, ref_info["depth_range"])
    for chunk, n_chunks in ((256, 16), (4096, 2)):
        ys, xs = torch.meshgrid(
            torch.arange(H // 2 - 4, H // 2 + 4, device="cuda"),
            torch.arange(W, device="cuda"), indexing="ij")
        coords = torch.stack([xs, ys], -1).reshape(-1, 1, chunk, 2).float()
        hit = torch.rand(coords.shape[0], 1, chunk, 64, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))

        def run():
            for i in range(n_chunks):
                model.render_fine_from_hit(ref, coords[i % len(coords)],
                                           hit[i % len(coords)], c2w_t,
                                           qdr_t, dr_t)
        profile_chunks("profile", f"{n_chunks} serving fine chunks of "
                       f"{chunk} rays", run, n_chunks)
    return launches, mlp3_launches


def cuda_f32(*arrays) -> list:
    """Each array as a float32 tensor on the card."""
    return [torch.as_tensor(a, dtype=torch.float32, device="cuda")
            for a in arrays]


def profile_chunks(phase: str, what: str, run, n_chunks: int,
                   ops: tuple = ()) -> None:
    """torch.profiler over ``run()`` (``n_chunks`` chunks, under inference
    mode, after one unprofiled call): device time by kernel and by PyTorch
    operator, host time by operator, the share of the window the device
    was busy, and the device time of each operator named in ``ops``."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            torch.inference_mode():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _cuda_kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    events = prof.key_averages()
    aten = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith("aten::")]

    def top_ops(attr):
        aten.sort(key=lambda e: -getattr(e, attr))
        return [{"op": e.key, "us_per_chunk": getattr(e, attr) / n_chunks,
                 "calls_per_chunk": e.count / n_chunks} for e in aten[:8]]
    emit({"phase": phase, "what": what,
          "wall_us_per_chunk": wall_us / n_chunks,
          "device_busy_us_per_chunk": busy / n_chunks,
          "device_busy_share": busy / wall_us,
          "kernels_per_chunk": sum(r[2] for r in rows) / n_chunks,
          "top_kernels": [{"kernel": k[:80], "us_per_chunk": t / n_chunks,
                           "count_per_chunk": c / n_chunks}
                          for k, t, c in rows[:8]],
          "top_ops_device": top_ops("self_device_time_total"),
          "top_ops_host": top_ops("self_cpu_time_total"),
          "ops_device_us_per_chunk": {
              e.key: e.self_device_time_total / n_chunks for e in events
              if e.key in ops}})


def cuda_vs_cpu() -> None:
    """The same seeded model renders a 64x128 serving frame (float32) on
    the card, through the kernels, and on the CPU, through the plain
    versions; rgb agrees within 2e-3."""
    h, w, dh, dw = 64, 128, 32, 64
    ref_info, c2w, qdr = bench.bench_inputs(h, w, dh, dw)
    rgbs, launches = {}, 0
    for device in ("cuda", "cpu"):
        model = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=(dh, dw),
            **preset_kwargs("serving", compute_dtype="float32"),
            device=device, generator=torch.Generator().manual_seed(1))
        ref = full_render.prepare_ref_data(model, ref_info, device=device)
        fused_mlp.reset_launches()
        rgbs[device] = full_render.render_image_device(
            model, ref, c2w, qdr, ref_info["depth_range"], chunk=256,
            coarse_lowres=2, device=device).cpu()
        if device == "cuda":
            launches = fused_mlp.MLP2_LAUNCHES
            assert_specialised("cuda_vs_cpu", launches,
                               fused_mlp.VARIANT_LAUNCHES)
    err = (rgbs["cuda"] - rgbs["cpu"]).abs().max().item()
    emit({"phase": "cuda_vs_cpu", "hw": [h, w], "dtype": "float32",
          "mlp2_launches_cuda": launches, "max_abs_err_rgb": err,
          "rgb_std": rgbs["cpu"].std().item()})
    if launches == 0 or not err <= 2e-3:
        raise AssertionError(f"cuda vs cpu: err {err}, launches {launches}")


# ---------------------------------------------------------------------------
# renderer training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 6          # 1 warm-up + 5 timed


def timed_training(phase: str, build, fit, params, finish,
                   meta: dict, launches_per_step: int = 2) -> tuple:
    """A trainer from ``build(on_step)``, ``fit(trainer)`` of TRAIN_STEPS
    steps, then ``finish(trainer)`` (save, validate; its dict joins the
    phase's line).  ms/step is the median of the CUDA-event intervals
    between consecutive step ends; ``peak_mem_bytes`` is the peak of the
    steps alone, ``build_peak_mem_bytes`` that of the build (which renders
    the scenes on the card).  Asserts finite losses, that every tensor of
    ``params(trainer)`` ((name, tensor) pairs, kept between build and fit)
    moved and the mlp2 launches per step (one ``out_geometry_fc`` launch
    per pass: ``launches_per_step``, coarse and fine by default), all
    ``lanes``.  ``meta`` describes the recipe in the phase's line.  Returns
    (trainer, row, steps)."""
    steps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps.append({"step": step, "loss": metrics["loss"],
                      "terms": metrics, "t": time.perf_counter(), "ev": ev,
                      "mlp2_launches": fused_mlp.MLP2_LAUNCHES,
                      "mlp3_launches": fused_mlp.MLP3_LAUNCHES,
                      "variants": dict(fused_mlp.VARIANT_LAUNCHES)})
        fused_mlp.reset_launches()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = build(on_step)
    init = {k: v.detach().clone() for k, v in params(trainer)}
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.reset_launches()
    fit(trainer)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    extra = finish(trainer)
    total_s = time.perf_counter() - t0
    still = [k for k, v in params(trainer) if torch.equal(v.detach(), init[k])]
    dev_ms = [a["ev"].elapsed_time(b["ev"]) for a, b in zip(steps, steps[1:])]
    host_ms = [(b["t"] - a["t"]) * 1e3 for a, b in zip(steps, steps[1:])]
    launches = [s["mlp2_launches"] for s in steps]
    losses = [s["loss"] for s in steps]
    row = {"phase": phase, **meta, "dtype": "float32", "steps": len(steps),
           "losses": losses,
           "terms_last": steps[-1]["terms"] if steps else None,
           "ms_per_step": statistics.median(dev_ms) if dev_ms else None,
           "ms_per_step_runs": dev_ms, "host_ms_runs": host_ms,
           "host_ms_per_step": statistics.median(host_ms) if host_ms
           else None, "cli_seconds": total_s, "peak_mem_bytes": peak,
           "build_peak_mem_bytes": build_peak,
           "mlp2_launches_per_step": launches,
           "mlp3_launches_per_step": [s["mlp3_launches"] for s in steps],
           "variant_launches_per_step": [s["variants"] for s in steps],
           "params_moved": len(init) - len(still), "params": len(init),
           "params_unchanged": still, **extra}
    emit(row)
    if len(steps) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    if still:
        raise AssertionError(f"{phase}: parameters unchanged after "
                             f"{TRAIN_STEPS} steps: {still}")
    if launches != [launches_per_step] * TRAIN_STEPS:
        raise AssertionError(f"{phase}: mlp2 launches per step {launches}, "
                             f"expected {launches_per_step} (one "
                             f"out_geometry_fc per pass)")
    for s in steps:
        assert_specialised(f"{phase} step {s['step']}", s["mlp2_launches"],
                           s["variants"])
    return trainer, row, steps


def train_cli(phase: str, argv: list, meta: dict) -> tuple:
    """The training CLI, in process, on ``argv``: ``train_renderer.build``,
    ``fit`` and ``save``, as its ``main`` runs them, through
    ``timed_training``.  Returns (trainer, batch stream, row, steps)."""
    argv = argv + ["--steps", str(TRAIN_STEPS), "--log-interval", "1"]
    built = {}

    def build(on_step):
        trainer, built["stream"], built["steps"] = train_renderer.build(
            train_renderer.parse_args(argv), on_step)
        return trainer

    trainer, row, steps = timed_training(
        phase, build,
        lambda t: t.fit(built["stream"], built["steps"],
                        key_metric="psnr_nr"),
        lambda t: t.model.state_dict().items(),
        lambda t: {"checkpoint": str(t.save("latest"))}, meta)
    return trainer, built["stream"], row, steps


def train_full_width() -> tuple:
    """The training CLI on the 2-view 512x1024 recipe at full width (64 +
    64 samples, 512 rays a step, render + depth losses, exp-decay lr,
    float32) over a pool of 2 scenes rendered on the card (``train_cli``),
    then a profile of one more step.  Returns (mlp2 launches per step,
    mlp3 launches over all steps, the checkpoint, ms/step)."""
    trainer, stream, row, _ = train_cli(
        "train", ["--cfg", TRAIN_CFG, "--pool", "2"],
        {"cfg": TRAIN_CFG, "hw": [H, W], "depth_hw": [DH, DW],
         "samples": [64, 64], "rays": 512})
    profile_train_step(lambda: trainer.fit(stream, 1))
    return (row["mlp2_launches_per_step"][-1],
            sum(row["mlp3_launches_per_step"]), trainer.ckpt_path("latest"),
            row["ms_per_step"])


def profile_train_step(step_once, phase: str = "train_profile") -> None:
    """Device time by kernel over one more training step, ``step_once()``
    (torch.profiler), and the share of the step the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _cuda_kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    emit({"phase": phase, "what": "one training step",
          "wall_us": wall_us, "device_busy_us": busy,
          "device_busy_share": busy / wall_us,
          "kernels": sum(r[2] for r in rows),
          "top_kernels": [{"kernel": k[:80], "us": t, "count": c}
                          for k, t, c in rows[:10]]})


def grad_limit_shares(grads_c: dict, grads_p: dict) -> tuple:
    """({parameter: its CUDA gradient's largest error against the CPU one,
    as a share of 1e-3 of the CPU gradient's largest element plus a
    floor}, the floor).  A parameter whose exact gradient is 0 (a conv bias
    in front of an instance norm) gets rounding noise on both sides: the
    floor is 1e-6 x the largest gradient of the tree."""
    floor = 1e-6 * max(g.abs().max().item() for g in grads_p.values())
    return {n: (grads_c[n] - grads_p[n]).abs().max().item()
            / (1e-3 * grads_p[n].abs().max().item() + floor)
            for n in grads_p}, floor


def train_cuda_vs_cpu() -> None:
    """One training step at 64x128 (depth 32x64, 32 + 32 samples, 512
    rays) from the same seeded weights, scene, rays and sampling draws, on
    CUDA through the kernels and on the CPU through the plain versions:
    loss within 1e-4 relative, each parameter's gradient within 1e-3 of
    its scale (plus a floor for the gradients that are exactly 0).

    The rays avoid the image's border rows and columns.  A ray in column
    0 points along -z, and so do its points as the reference views see
    them: their longitude sits on the +-pi seam, where the projection
    gives x = 0 or x = W - 1 by the sign of a rounding error, and the
    features gathered there jump by a pixel.  With border rays one CPU
    step in float32 and in float64 differ by 2e-3 in the loss; without
    them by 2e-7."""
    h, w, dh, dw, dn = 64, 128, 32, 64, 32
    scene = SphereScene.random(5)
    sample = make_three_view_sample(scene, h, w, 1.0, seed=5)      # on CPU
    coords = imgs_info.sample_train_coords(np.random.default_rng(5), h - 2,
                                           w - 2, 512) + 1
    cfg = trainer_mod.TrainerConfig(losses=("render", "depth"), seed=5)
    results = {}
    for device in ("cuda", "cpu"):
        model = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=(dh, dw), depth_sample_num=dn,
            fine_depth_sample_num=dn, gather_depth_major=True,
            device=device, generator=torch.Generator().manual_seed(5))
        s = {k: v.to(device) for k, v in sample.items()}
        data = imgs_info.build_render_sample(s, coords.to(device),
                                             src_for_mvs=False)
        data["ref_imgs_info"]["mvs_depth"] = resize_linear(
            s["depth_panos"][list(imgs_info.REF_IDS)], (dh, dw), axes=(1, 2))
        opt, schedule = trainer_mod.make_optimizer(cfg, model.parameters())
        step = trainer_mod.make_train_step(lambda b, g: model(b, g), cfg,
                                           opt, schedule)
        fused_mlp.reset_launches()
        metrics = step(data, torch.Generator().manual_seed(5), 0)
        launches = fused_mlp.MLP2_LAUNCHES
        if device == "cuda":
            assert_specialised("train_cuda_vs_cpu", launches,
                               fused_mlp.VARIANT_LAUNCHES)
        results[device] = (float(metrics["loss"]),
                           {n: p.grad.detach().cpu()
                            for n, p in model.named_parameters()}, launches)
    (loss_c, grads_c, launches), (loss_p, grads_p, _) = results.values()
    share, floor = grad_limit_shares(grads_c, grads_p)
    bad = [n for n, s in share.items() if s > 1]
    worst = sorted(share.items(), key=lambda kv: -kv[1])[:5]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    emit({"phase": "train_cuda_vs_cpu", "hw": [h, w], "depth_hw": [dh, dw],
          "samples": [dn, dn], "rays": 512, "dtype": "float32",
          "loss_cuda": loss_c, "loss_cpu": loss_p, "loss_rel_err": loss_rel,
          "mlp2_launches_cuda": launches, "params": len(grads_p),
          "grad_worst_limit_share": worst, "grad_abs_floor": floor,
          "params_over_limit": bad})
    if launches != 2 or not loss_rel <= 1e-4 or bad:
        raise AssertionError(f"train cuda vs cpu: loss rel {loss_rel}, "
                             f"launches {launches}, over limit {bad}")


# ---------------------------------------------------------------------------
# the depth stack and the composed serving pipeline
# ---------------------------------------------------------------------------

def timed_ms(fn, runs: int = 3) -> tuple:
    """(median, runs) of CUDA-event milliseconds of ``fn`` after one
    warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def depth_stack_full_width() -> None:
    """The frozen stack at its defaults (UniFuse at 512x1024, the MVS net
    at 256x512 with 64 hypotheses and a 3D UNet of base 32; random weights
    from seed 0) on the 2 reference views of a 512x1024 procedural scene:
    ms per scene (median of 3 after a warm-up), the mono net's share, peak
    memory, the convolutions' operations (FlopCounterMode), a profile of
    one call; depth of the expected shapes, finite and non-negative."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    sample = make_three_view_sample(SphereScene.random(7, device="cuda"), H,
                                    W, 0.5, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stack = depth_stack.init_depth_stack(0, device="cuda")

    def run():
        return depth_stack.stack_depth_for_sample(
            stack, sample, imgs_info.REF_IDS, imgs_info.SRC_IDS)
    out = run()
    ms, runs = timed_ms(run)
    peak = torch.cuda.max_memory_allocated() - base
    ref = sample["rgb_panos"][list(imgs_info.REF_IDS)]
    with torch.inference_mode():
        mono_ms, mono_runs = timed_ms(lambda: depth_stack.run_mono(
            stack.mono_model, ref, stack.mono_hw))
    with FlopCounterMode(display=False) as counter:
        run()
    flops = counter.get_total_flops()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = _cuda_kernel_rows(prof)
    rows.sort(key=lambda r: -r[1])
    depth, mono = out["mvs_depth"], out["mono_depth"]
    emit({"phase": "depth_stack", "mono_hw": list(stack.mono_hw),
          "depth_hw": list(stack.depth_hw), "views": 2,
          "hypotheses": stack.mvs_model.num_hypotheses, "dtype": "float32",
          "tf32": False, "ms_per_scene": ms, "ms_per_scene_runs": runs,
          "mono_ms": mono_ms, "mono_ms_runs": mono_runs,
          "mvs_ms": ms - mono_ms, "peak_mem_bytes": peak, "flops": flops,
          "tflops_per_s": flops / ms / 1e9,
          "kernels": sum(r[2] for r in rows),
          "device_busy_us": sum(r[1] for r in rows),
          "top_kernels": [{"kernel": k[:80], "us": t, "count": c}
                          for k, t, c in rows[:10]],
          "mvs_depth_shape": list(depth.shape),
          "mono_depth_shape": list(mono.shape),
          "mvs_depth_mean": depth.mean().item(),
          "mvs_depth_max": depth.max().item(),
          "mono_depth_mean": mono.mean().item()})
    if tuple(depth.shape) != (RFN, DH, DW, 1) or \
            tuple(mono.shape) != (RFN, H, W, 1):
        raise AssertionError(f"depth stack shapes {tuple(depth.shape)}, "
                             f"{tuple(mono.shape)}")
    for t in (depth, mono):
        if not torch.isfinite(t).all() or t.min() < 0:
            raise AssertionError("depth stack: non-finite or negative depth")


def small_stack(device: str):
    """The stack at the tests' small shapes (mono 64x128, MVS 32x64, 8
    hypotheses, 3D UNet base 8), seeded; the depth head's last bias is
    positive so the random net's depth is not near 0."""
    stack = depth_stack.init_depth_stack(
        3, mono_hw=(64, 128), depth_hw=(32, 64),
        mvs_kwargs={"num_hypotheses": 8, "magnet_num_samples": 3,
                    "cnn3d_base": 8}, device=device)
    with torch.no_grad():
        stack.mvs_model.decoders2[2].conv2.bias.fill_(3.0)
    return stack


def depth_stack_cuda_vs_cpu() -> None:
    """The small stack on CUDA (cuDNN, TF32 off) against the CPU, float32:
    each depth within 1e-3 of its scale.  (A floor of a sweep coordinate
    near an integer may fall on either side between the devices and move
    one sample of the cost volume, hence not 1e-5.)"""
    sample = make_three_view_sample(SphereScene.random(8), 32, 64, 0.5,
                                    seed=8)
    outs = {}
    for device in ("cuda", "cpu"):
        s = {k: v.to(device) for k, v in sample.items()}
        outs[device] = {k: v.cpu() for k, v in
                        depth_stack.stack_depth_for_sample(
                            small_stack(device), s,
                            imgs_info.REF_IDS).items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in outs["cpu"]}
    scales = {k: v.abs().max().item() for k, v in outs["cpu"].items()}
    emit({"phase": "depth_stack_cuda_vs_cpu", "mono_hw": [64, 128],
          "depth_hw": [32, 64], "dtype": "float32", "max_abs_err": errs,
          "mean_abs_err": {k: (outs["cuda"][k] - outs["cpu"][k]).abs()
                           .mean().item() for k in errs},
          "scale": scales})
    bad = [k for k in errs if not errs[k] <= 1e-3 * scales[k]]
    if bad:
        raise AssertionError(f"depth stack cuda vs cpu: {bad} {errs}")


# ---------------------------------------------------------------------------
# depth-network training
# ---------------------------------------------------------------------------

DEPTH_STEPS = 6          # 1 warm-up + 5 timed
DEPTH_RUNS = "data/depth_model"
MVS_CFG = "configs/depth/m3d_mvs.yaml"
CONV_KERNELS = re.compile(r"xmma|conv|cudnn|winograd|fft|implicit_gemm|"
                          r"dgrad|wgrad|gemm", re.I)


def _bn_buffers(module: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def depth_train_cli(phase: str, tool, argv: list,
                    expect_bn: bool = True) -> tuple:
    """A depth-training CLI in process on the card, as its ``main`` runs
    it without the restore: ``build``, ``fit`` of DEPTH_STEPS steps and
    ``save``.  ms/step is the median of the CUDA-event intervals between
    consecutive step ends (each step draws its batch: scene rendering on
    the card and, for MVS, the frozen prior).  Asserts finite losses,
    that every parameter and every BatchNorm running statistic moved (and
    that there are some, unless ``expect_bn`` is False), and that neither
    MLP kernel launched.  Returns (trainer, batch stream, checkpoint path,
    mlp2 launches, mlp3 launches)."""
    steps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps.append({"step": step, "loss": metrics["loss"],
                      "t": time.perf_counter(), "ev": ev})

    name = argv[argv.index("--name") + 1]
    shutil.rmtree(f"{DEPTH_RUNS}/{name}", ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = tool.parse_args(argv)
    trainer, stream, num_steps = tool.build(args, on_step)
    model = trainer.model
    params0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    bn0 = _bn_buffers(model)
    fused_mlp.reset_launches()
    trainer.fit(stream, num_steps)
    torch.cuda.synchronize()
    mlp2, mlp3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
    path = trainer.save()
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    dev_ms = [a["ev"].elapsed_time(b["ev"]) for a, b in zip(steps, steps[1:])]
    host_ms = [(b["t"] - a["t"]) * 1e3 for a, b in zip(steps, steps[1:])]
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), params0[k])]
    bn1 = _bn_buffers(model)
    bn_still = [k for k in bn0 if torch.equal(bn0[k], bn1[k])]
    losses = [s["loss"] for s in steps]
    emit({"phase": phase, "argv": argv, "hw": [args.height, args.width],
          "batch": args.batch, "dtype": "float32", "tf32": False,
          "steps": len(steps), "losses": losses,
          "ms_per_step": statistics.median(dev_ms) if dev_ms else None,
          "ms_per_step_runs": dev_ms, "host_ms_runs": host_ms,
          "cli_seconds": total_s, "peak_mem_bytes": peak,
          "params": sum(p.numel() for p in model.parameters()),
          "param_tensors": len(params0), "params_unchanged": still,
          "bn_buffers": len(bn0), "bn_buffers_unchanged": bn_still,
          "mlp2_launches": mlp2, "mlp3_launches": mlp3,
          "checkpoint": str(path)})
    if len(steps) != DEPTH_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses}")
    if still or bn_still or (expect_bn and not bn0):
        raise AssertionError(f"{phase}: unchanged after {DEPTH_STEPS} steps: "
                             f"parameters {still}, BatchNorm {bn_still}")
    if mlp2 or mlp3:
        raise AssertionError(f"{phase}: mlp2 {mlp2}, mlp3 {mlp3} launches on "
                             "a path without them")
    return trainer, stream, path, mlp2, mlp3


def depth_train_full_width() -> dict:
    """The mono recipe (UniFuse ResNet-18, cee fusion with SE, 512x1024,
    batch 2, l1_sphere) and then the MVS recipe of ``m3d_mvs.yaml``
    (256x512, batch 2, 64 hypotheses, 5 MaGNet samples, UNet3D base 32,
    l1_sphere + 0.5 x the aux L1) on the mono run's checkpoint; a profile
    and the operations of one more MVS step.  Returns the checkpoints and
    the MLP kernels' launches of each run."""
    _, _, mono_ckpt, m2a, m3a = depth_train_cli(
        "depth_train_mono", train_mono,
        ["--height", str(H), "--width", str(W), "--batch", "2", "--steps",
         str(DEPTH_STEPS), "--name", "chip_smoke_mono", "--log-interval",
         "1", "--vis-interval", "0", "--device", "cuda"])
    mvs, stream, mvs_ckpt, m2b, m3b = depth_train_cli(
        "depth_train_mvs", train_depth,
        ["--cfg", MVS_CFG, "--steps", str(DEPTH_STEPS), "--name",
         "chip_smoke_mvs", "--mono-ckpt", str(mono_ckpt), "--log-interval",
         "1", "--vis-interval", "0", "--device", "cuda"])
    # the MVS run's frozen prior is the mono run's checkpoint
    read = depth_stack.read_checkpoint(mono_ckpt)
    prior = mvs.frozen["d_net"].state_dict()
    if set(read) != set(prior) or any(
            not torch.equal(prior[k].cpu(), read[k]) for k in read):
        raise AssertionError("depth_train_mvs: the frozen prior is not the "
                             "mono checkpoint")
    profile_depth_step(mvs, stream)
    return {"mono_ckpt": mono_ckpt, "mvs_ckpt": mvs_ckpt,
            "mlp2": {"mono": m2a, "mvs": m2b}, "mlp3": m3a + m3b}


def profile_depth_step(trainer, stream) -> None:
    """One more MVS step under FlopCounterMode (operations) and one under
    torch.profiler: device-busy share, kernels, the top kernels, the
    sweep's backward scatter (autograd's accumulating ``index_put_``) and
    the convolutions' share of the device time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        trainer.fit(stream, 1)
    flops = counter.get_total_flops()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(stream, 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _cuda_kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    ops = {e.key: e.device_time_total for e in prof.key_averages()
           if e.key in ("aten::_index_put_impl_", "aten::index_put_",
                        "aten::index", "aten::index_add_",
                        "aten::convolution_backward", "aten::convolution")}
    conv_us = sum(t for k, t, _ in rows if CONV_KERNELS.search(k))
    scatter = [(k, t, c) for k, t, c in rows
               if re.search("index_put|indexing_backward|sort", k)]
    emit({"phase": "depth_train_profile", "what": "one MVS training step "
          f"({MVS_CFG}, batch 2)", "flops": flops,
          "wall_us": wall_us, "device_busy_us": busy,
          "device_busy_share": busy / wall_us,
          "tflops_per_s_busy": flops / busy / 1e6 if busy else None,
          "kernels": sum(r[2] for r in rows),
          "conv_us": conv_us, "conv_share_of_busy": conv_us / busy,
          "op_device_us": ops,
          "top_kernels": [{"kernel": k[:80], "us": t, "count": c}
                          for k, t, c in rows[:12]]})
    # the sweep's gradient w.r.t. the source features, on its own line
    emit({"phase": "depth_train_profile", "what": "sweep backward scatter "
          "(index_put_ accumulate)",
          "index_put_device_us": ops.get("aten::_index_put_impl_",
                                         ops.get("aten::index_put_")),
          "kernels": [{"kernel": k[:80], "us": t, "count": c}
                      for k, t, c in scatter]})


def _small_depth_step(device: str, recipe: str,
                      dtype: torch.dtype = torch.float32) -> dict:
    """One training forward and backward of a small recipe on ``device``
    in ``dtype`` from seeded weights (random BatchNorm statistics) and
    inputs made on the CPU: the loss, each parameter's gradient and the
    BatchNorm running statistics it updated."""
    g = torch.Generator().manual_seed(11)
    if recipe == "mono":
        model = tunifuse.UniFuse()
        s = make_three_view_sample(SphereScene.random(11), 64, 128, 0.5,
                                   seed=11)
        equi = tunifuse.normalize_imagenet(s["rgb_panos"][:2])
        batch = {"equi": equi, "cube": cubemap.equi_to_cube(equi, 32),
                 "gt_depth": torch.clamp(s["depth_panos"][:2], 0, 10)}

        def forward(b):
            return model(b["equi"], b["cube"])
    else:
        model = tmvs.MVSDepthModel(num_hypotheses=8, magnet_num_samples=3,
                                   cnn3d_base=8)
        s = make_three_view_sample(SphereScene.random(12), 32, 64, 1.0,
                                   seed=12)
        # views moved off each other's longitude seam (ROADMAP Queue 3)
        trans = s["trans"] + torch.tensor(
            [[0.11, -0.04, 0.0], [-0.07, 0.05, 0.0], [0.03, 0.09, 0.0]])
        mono_depth = resize_linear(s["depth_panos"][1:2], (64, 128),
                                   axes=(1, 2))
        batch = {"panos": s["rgb_panos"][None, :2].repeat(2, 1, 1, 1, 1),
                 "rots": s["rots"][None, :2].repeat(2, 1, 1, 1),
                 "trans": trans[None, :2].repeat(2, 1, 1),
                 "mono_depth": (mono_depth * torch.tensor([0.9, 1.1])[
                     :, None, None, None]),
                 "mono_feat": torch.randn(2, 32, 64, 32, generator=g),
                 "gt_depth": torch.clamp(s["depth_panos"][1:2], 0, 10)
                 .repeat(2, 1, 1, 1)}

        def forward(b):
            out = model(*(b[k] for k in ("panos", "rots", "trans",
                                         "mono_depth", "mono_feat")))
            out["pred_depth"] = out.pop("depth")
            return out
    return _seeded_step(model, forward, batch, device, dtype, g,
                        aux_d1=recipe == "mvs")


def _seeded_step(model, forward, batch: dict, device: str,
                 dtype: torch.dtype, g: torch.Generator,
                 aux_d1: bool) -> dict:
    """``model`` seeded (random BatchNorm statistics from ``g``), moved to
    ``device`` and ``dtype`` with ``batch``, then one training forward and
    backward of the depth trainer's loss: the loss, each parameter's
    gradient and the updated BatchNorm running statistics, on the CPU in
    float64."""
    tblocks.init_parameters_(model, torch.Generator().manual_seed(13))
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.copy_(torch.randn(m.num_features, generator=g)
                                 * 0.2)
            m.running_var.copy_(torch.rand(m.num_features, generator=g)
                                + 0.5)
    model.to(device, dtype).train()
    batch = {k: v.to(device, dtype) for k, v in batch.items()}
    trainer = depth_trainer.DepthTrainer(
        model, forward, depth_trainer.DepthTrainConfig(
            aux_d1_weight=0.5 if aux_d1 else 0.0))
    loss = trainer.loss(forward(batch), batch)
    loss.backward()
    return {"loss": loss.item(),
            "grads": {k: p.grad.detach().cpu().double()
                      for k, p in model.named_parameters()},
            "bn": {k: v.cpu().double()
                   for k, v in _bn_buffers(model).items()}}


def depth_train_cuda_vs_cpu() -> None:
    """One small training forward and backward of each recipe (UniFuse
    at 64x128; the MVS net at 32x64 with 8 hypotheses, 3 MaGNet samples
    and UNet3D base 8) on CUDA against the same on the CPU, float32, TF32
    off: the loss within 1e-4 relative, each parameter's gradient within
    1e-3 of its L2 norm plus 1e-6 of the tree's largest norm (the error's
    L2 norm: single elements of the deep convolutions' gradients, behind
    BatchNorms over 1x1 and 2x4 maps, differ by 1.2e-3 of the largest
    element), and each updated BatchNorm running statistic within 1e-4 of
    its scale.  The limits cover the cuDNN algorithms' other summation
    order and the CUDA gradients' nondeterminism (the atomic adds of
    index_add_ in the resizes' backward, ~1e-6); the MVS views sit off
    each other's seam."""
    for recipe in ("mono", "mvs"):
        cu, cp = (_small_depth_step(d, recipe) for d in ("cuda", "cpu"))
        compare_steps("depth_train_cuda_vs_cpu", {"recipe": recipe}, cu, cp)


def compare_steps(phase: str, meta: dict, cu: dict, cp: dict,
                  cp64: dict | None = None) -> None:
    """A training step on CUDA against the same on the CPU, both float32:
    the loss within 1e-4 relative, each parameter's gradient within 1e-3
    of its L2 norm plus 1e-6 of the tree's largest norm (the error's L2
    norm), each updated BatchNorm statistic within 1e-4 of its scale.
    With ``cp64`` (the CPU step in float64) a gradient past its limit is
    still held if the CUDA one is as close to float64 as the CPU one (its
    error at most twice the CPU's plus the limit): the difference is then
    float32 rounding of an ill-conditioned gradient, not the card's."""
    loss_rel = abs(cu["loss"] - cp["loss"]) / abs(cp["loss"])
    floor = 1e-6 * max(g.norm().item() for g in cp["grads"].values())
    limit = {k: 1e-3 * g.norm().item() + floor
             for k, g in cp["grads"].items()}
    share = {k: (cu["grads"][k] - g).norm().item() / limit[k]
             for k, g in cp["grads"].items()}
    max_share = {k: (cu["grads"][k] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-12)
                 for k, g in cp["grads"].items()}
    bn = {k: (cu["bn"][k] - v).abs().max().item()
          / (1e-4 * max(v.abs().max().item(), 1e-6))
          for k, v in cp["bn"].items()}
    over = [k for k, v in share.items() if v > 1]
    rounding = {}
    if cp64 is not None:
        for k in over:
            exact = cp64["grads"][k]
            rounding[k] = {
                "cuda_vs_f64": (cu["grads"][k] - exact).norm().item(),
                "cpu_vs_f64": (cp["grads"][k] - exact).norm().item()}
        over = [k for k in over if rounding[k]["cuda_vs_f64"]
                > 2 * rounding[k]["cpu_vs_f64"] + limit[k]]
    bad = over + [k for k, v in bn.items() if v > 1]
    emit({"phase": phase, **meta, "dtype": "float32",
          "loss_cuda": cu["loss"], "loss_cpu": cp["loss"],
          "loss_rel_err": loss_rel,
          "grad_worst_limit_share": sorted(
              share.items(), key=lambda kv: -kv[1])[:3],
          "grad_worst_max_abs_rel": sorted(
              max_share.items(), key=lambda kv: -kv[1])[:3],
          "grad_over_limit_float32_rounding": rounding,
          "bn_worst_limit_share": sorted(
              bn.items(), key=lambda kv: -kv[1])[:3],
          "over_limit": bad})
    if not loss_rel <= 1e-4 or bad:
        raise AssertionError(f"{phase} {meta}: loss rel {loss_rel}, over "
                             f"limit {bad}")


def depth_eval(mono_ckpt, mvs_ckpt) -> None:
    """``tools.eval_depth`` on the card at 256x512 from the two
    checkpoints: the metric table of 4 scenes, finite."""
    fused_mlp.reset_launches()
    table = eval_depth.main(["--mono-ckpt", str(mono_ckpt), "--mvs-ckpt",
                             str(mvs_ckpt), "--device", "cuda"])
    emit({"phase": "depth_eval", "hw": [DH, DW], "scenes": 4,
          "table": table, "mlp2_launches": fused_mlp.MLP2_LAUNCHES,
          "mlp3_launches": fused_mlp.MLP3_LAUNCHES})
    if not all(np.isfinite(v) for net in table.values()
               for v in net.values()):
        raise AssertionError(f"depth_eval: {table}")


RENDER_OUT = "data/chip_smoke_render"


def random_mvs_ckpt() -> Path:
    """A seeded MVS net (the stack's default configuration) saved in the
    reference layout, for ``render_cli`` when the depth-training group
    writes no MVS checkpoint."""
    mvs = tmvs.MVSDepthModel()
    tblocks.init_parameters_(mvs, torch.Generator().manual_seed(0))
    path = Path(RENDER_OUT) / "random_mvs.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model_state_dict": mvs.state_dict()}, path)
    return path


def render_cli(mvs_ckpt) -> dict:
    """The render CLI (``tools.render.main``) at 512x1024 under the
    serving preset at 4096-ray chunks, reference depth from the depth
    stack with the MVS net of ``mvs_ckpt`` (the depth-training group's, or
    ``random_mvs_ckpt``'s): one eval frame with its metrics, then a path
    of 4 poses at a frame batch of 2 and of 1.  Asserts that the stack
    ran the MVS net and the mlp2 launches: an eval frame 160, a 2-pose
    group as many as one frame, all ``lanes``; mlp3 none.  Returns the
    launches per path."""
    chunk = 4096
    per_frame = H * W // chunk + (H // 2) * (W // 2) // chunk
    argv = ["--height", str(H), "--width", str(W), "--depth-height", str(DH),
            "--depth-width", str(DW), "--depth-stack", "--mvs-ckpt",
            str(mvs_ckpt), "--preset", "serving", "--chunk", str(chunk),
            "--num", "1", "--no-skip", "--out", RENDER_OUT]
    runs = {"eval": ([], 1), "inter_b2": (["--pose-type", "inter",
                                           "--inter-num", "4",
                                           "--frame-batch", "2"], 2),
            "inter_b1": (["--pose-type", "inter", "--inter-num", "4",
                          "--frame-batch", "1"], 4)}
    result = {}
    for name, (extra, passes) in runs.items():
        fused_mlp.reset_launches()
        t0 = time.perf_counter()
        summary = render_tool.main(argv + extra)
        seconds = time.perf_counter() - t0
        count, count3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
        variants = dict(fused_mlp.VARIANT_LAUNCHES)
        row = {"phase": "render_cli", "run": name, "hw": [H, W],
               "preset": "serving", "chunk": chunk,
               "mlp2_launches": count, "mlp2_launches_per_group":
                   count / passes, "mlp3_launches": count3,
               "variant_launches": variants, "cli_seconds": seconds,
               "depth_stack": summary["depth_stack"],
               "stack_seconds": summary["stack_seconds"]}
        if name == "eval":
            row.update(summary["mean"])
            ok = all(np.isfinite(v) for v in summary["mean"].values())
        else:
            row.update(summary["videos"][0])
            ok = summary["videos"][0]["frames"] == 4
        emit(row)
        if not ok or summary["depth_stack"]["mvs"] != str(mvs_ckpt):
            raise AssertionError(f"render_cli {name}: {summary}")
        if count != passes * per_frame or count3:
            raise AssertionError(f"render_cli {name}: mlp2 launched {count}"
                                 f" times, expected {passes} x {per_frame};"
                                 f" mlp3 {count3}")
        assert_specialised(f"render_cli {name}", count, variants)
        result[name] = count
    return result


def video_cuda() -> None:
    """render_video_device at B = 3 against render_image_device for each
    pose, on the card at 64x128 (serving flags, float32, coarse pass at
    half resolution): rgb within 2e-3 (the CUDA-against-CPU limit: the
    batched products may round differently); the 3-pose group launches
    mlp2 as often as one frame."""
    h, w, dh, dw = 64, 128, 32, 64
    ref_info, c2w, qdr = bench.bench_inputs(h, w, dh, dw)
    model = NeuralRayGenRenderer(
        height=h, width=w, depth_hw=(dh, dw),
        **preset_kwargs("serving", compute_dtype="float32"), device="cuda",
        generator=torch.Generator().manual_seed(2))
    ref = full_render.prepare_ref_data(model, ref_info)
    c2ws = np.stack([c2w + np.asarray([[0, 0, 0, dx]] * 3)
                     for dx in (0.0, 0.1, 0.2)])
    args = (qdr, ref_info["depth_range"])
    fused_mlp.reset_launches()
    video = full_render.render_video_device(model, ref, c2ws, *args,
                                            chunk=256, coarse_lowres=2)
    launches = fused_mlp.MLP2_LAUNCHES
    fused_mlp.reset_launches()
    frames = [full_render.render_image_device(model, ref, c, *args,
                                              chunk=256, coarse_lowres=2)
              for c in c2ws]
    frame_launches = fused_mlp.MLP2_LAUNCHES / len(c2ws)
    errs = [(video[b] - frames[b]).abs().max().item() for b in range(3)]
    emit({"phase": "video_cuda", "hw": [h, w], "dtype": "float32",
          "frames": 3, "max_abs_err_rgb": errs,
          "mlp2_launches_group": launches,
          "mlp2_launches_per_frame": frame_launches})
    if not max(errs) <= 2e-3 or launches != frame_launches:
        raise AssertionError(f"video_cuda: errs {errs}, launches {launches}"
                             f" vs {frame_launches} per frame")


# ---------------------------------------------------------------------------
# multi-view training, the consistency loss and per-scene finetuning
# ---------------------------------------------------------------------------

MV_CFG = ("configs/gen/"
          "neuray_gen_cv_erp_mono_stereo_uniform_512x1024_mv_v4.yaml")
FT_CFG = "configs/ft/neuray_ft_cv_m3d_diff_mono_uniform.yaml"
MV_RUNS = "data/chip_smoke_mv"


def train_mv() -> tuple:
    """The training CLI (``train_cli``) on the V = 4 recipe of ``MV_CFG``
    (512x1024, depth 256x512, references [0, 1, 2], query 3, 512 rays,
    64 + 64 samples, render + depth losses, float32) over a pool of 2
    four-view scenes, then the same recipe with the consistency loss
    (``use_self_hit_prob``, losses render + depth + consistency; no
    shipped config turns it on, so a derived yaml is written under
    MV_RUNS), which encodes the query view too, and a profile of one
    more step of that recipe.  Asserts finite
    consistency terms of both passes at every step.  Returns ({phase: mlp2
    launches per step}, mlp3 launches, the V = 4 run's checkpoint)."""
    meta = {"cfg": MV_CFG, "hw": [H, W], "depth_hw": [DH, DW],
            "samples": [64, 64], "rays": 512, "views": 4,
            "refs": [0, 1, 2], "query": [3]}
    trainer, _, row_mv, _ = train_cli(
        "train_mv", ["--cfg", MV_CFG, "--pool", "2"], meta)
    ckpt = trainer.ckpt_path("latest")
    del trainer
    cfg = yaml.safe_load(Path(MV_CFG).read_text())
    cfg.update(name="chip_smoke_mv_consistency", use_self_hit_prob=True,
               loss=["render", "depth", "consistency"])
    path = Path(MV_RUNS) / "mv_v4_consistency.yaml"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    trainer, stream, row_c, steps = train_cli(
        "train_consistency", ["--cfg", str(path), "--pool", "2"],
        {**meta, "cfg": str(path), "losses": cfg["loss"]})
    profile_train_step(lambda: trainer.fit(stream, 1),
                       "train_consistency_profile")
    prob = [[s["terms"].get(k) for k in ("loss_prob", "loss_prob_fine")]
            for s in steps]
    if not all(v is not None and np.isfinite(v) for p in prob for v in p):
        raise AssertionError(f"train_consistency: loss_prob terms {prob}")
    rows = {"train_mv": row_mv, "train_consistency": row_c}
    return ({k: r["mlp2_launches_per_step"][-1] for k, r in rows.items()},
            sum(sum(r["mlp3_launches_per_step"]) for r in rows.values()),
            ckpt)


def train_ft_full_width(gen_ckpt) -> tuple:
    """The ``train_ft`` CLI on ``FT_CFG`` (512x1024, depth 256x512, ray
    features 64x128 per view, 512 rays, 64 + 64 samples, render loss,
    Adam at 1e-2 on the ray features and 1e-4 on the rest) with depth
    guidance, from the training group's gen checkpoint, or from a seeded
    gen renderer saved here when that group did not run: ``FtTrainer``,
    ``fit`` of TRAIN_STEPS steps, ``validate`` and ``save``, as its
    ``main`` runs them, through ``timed_training`` (so every parameter,
    the ray features and the network's weights, must move).  Asserts too
    a finite validation MSE and the two groups' learning rates; then
    profiles one more step.  Returns (mlp2 launches per step, mlp3
    launches, the ft checkpoint)."""
    if gen_ckpt is None:
        gen = NeuralRayGenRenderer(height=H, width=W, depth_hw=(DH, DW),
                                   device="cuda",
                                   generator=torch.Generator().manual_seed(0))
        gen_ckpt = Path(MV_RUNS) / "gen_seeded" / "model.pth"
        gen_ckpt.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"network_state_dict": gen.state_dict()}, gen_ckpt)
        del gen
    argv = ["--cfg", FT_CFG, "--gen-ckpt", str(gen_ckpt), "--steps",
            str(TRAIN_STEPS), "--depth-guided", "--log-interval", "1",
            "--name", "chip_smoke_ft", "--device", "cuda"]
    args = train_ft.parse_args(argv)
    trainer, row, _ = timed_training(
        "train_ft", lambda on_step: train_ft.FtTrainer(args, on_step),
        lambda t: t.fit(args.steps), lambda t: t.model.named_parameters(),
        lambda t: {"val": t.validate(), "checkpoint": str(t.save()),
                   "lr_groups": [g["lr"] for g in t.opt.param_groups],
                   "ray_feats": list(t.model.ray_feats_maps().shape)},
        {"cfg": FT_CFG, "hw": [H, W], "depth_hw": [DH, DW],
         "samples": [64, 64], "rays": args.rays, "depth_guided": True})
    if not np.isfinite(row["val"]["mse"]):
        raise AssertionError(f"train_ft: val {row['val']}")
    lrs = row["lr_groups"]
    if lrs != [args.lr_ray_feats, args.lr] or lrs != [1e-2, 1e-4]:
        raise AssertionError(f"train_ft: learning rates {lrs}")
    profile_train_step(lambda: trainer.fit(1), "train_ft_profile")
    return (row["mlp2_launches_per_step"][-1],
            sum(row["mlp3_launches_per_step"]), Path(row["checkpoint"]))


RENDER_FT_OUT = "data/chip_smoke_render_ft"
RENDER_MV_OUT = "data/chip_smoke_render_mv"


def render_cli_runs(phase: str, tool, argv: list, runs: dict) -> tuple:
    """``tool.main`` on ``argv`` plus each run's flags at 4096-ray chunks,
    ``runs`` = {name: (flags, frames)}: the metrics (finite) or the path's
    frame count, s/frame, and exactly 2 mlp2 launches per chunk pass (the
    coarse and fine ``out_geometry_fc``), 256 per 512x1024 frame, all
    ``lanes``.  Returns ({run: mlp2 launches}, mlp3 launches)."""
    per_frame = 2 * (H * W // 4096)
    counts, mlp3 = {}, 0
    for name, (extra, frames) in runs.items():
        fused_mlp.reset_launches()
        t0 = time.perf_counter()
        summary = tool.main(argv + ["--chunk", "4096"] + extra)
        seconds = time.perf_counter() - t0
        count, count3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
        variants = dict(fused_mlp.VARIANT_LAUNCHES)
        metrics = summary.get("mean", summary)
        emit({"phase": phase, "run": name, "hw": [H, W], "chunk": 4096,
              "frames": frames, "mlp2_launches": count,
              "mlp3_launches": count3, "variant_launches": variants,
              "cli_seconds": seconds, **metrics})
        if not all(np.isfinite(v) for v in metrics.values()) or \
                metrics.get("frames", frames) != frames:
            raise AssertionError(f"{phase} {name}: {summary}")
        if count != frames * per_frame or count3:
            raise AssertionError(f"{phase} {name}: mlp2 launched {count} "
                                 f"times, expected {frames} x {per_frame};"
                                 f" mlp3 {count3}")
        assert_specialised(f"{phase} {name}", count, variants)
        counts[name] = count
        mlp3 += count3
    return counts, mlp3


def render_ft_cli(ft_ckpt) -> tuple:
    """``tools.render_ft`` at 512x1024 from the ft checkpoint: the held-out
    view's eval frame, then a 3-pose path."""
    argv = ["--ckpt", str(ft_ckpt), "--height", str(H), "--width", str(W),
            "--out", RENDER_FT_OUT, "--device", "cuda"]
    return render_cli_runs("render_ft", render_ft, argv, {
        "eval": ([], 1),
        "inter": (["--pose-type", "inter", "--inter-num", "3"], 3)})


def render_mv_cli(ckpt) -> tuple:
    """``tools.render_mv`` at 512x1024 (depth 256x512) from the V = 4 run's
    checkpoint: one frame of a V = 5 scene, the middle view from the 4
    others."""
    argv = ["--ckpt", str(ckpt), "--views", "5", "--que-idx", "2", "--num",
            "1", "--height", str(H), "--width", str(W), "--depth-height",
            str(DH), "--depth-width", str(DW), "--out", RENDER_MV_OUT,
            "--device", "cuda"]
    return render_cli_runs("render_mv", render_mv, argv, {"eval": ([], 1)})


def off_seam_coords(rng, n: int, h: int, w: int) -> torch.Tensor:
    """(1, n, 2) random pixel coords off the border and the middle column:
    the multi-view and 3-view scenes put their cameras on one axis, so a
    ray there has points on another view's longitude seam (see
    ``train_cuda_vs_cpu``)."""
    xs = rng.choice([x for x in range(1, w - 1) if abs(x - w // 2) > 1],
                    size=n)
    ys = rng.integers(1, h - 1, size=n)
    return torch.as_tensor(np.stack([xs, ys], -1)[None], dtype=torch.float32)


def _mv_step(device: str, sample: dict, coords) -> tuple:
    """One V = 4 consistency step at 64x128 on ``device``: (loss, grads,
    mlp2 launches, launches by variant)."""
    h, w, dh, dw, dn = 64, 128, 32, 64, 32
    model = NeuralRayGenRenderer(
        height=h, width=w, depth_hw=(dh, dw), depth_sample_num=dn,
        fine_depth_sample_num=dn, gather_depth_major=True,
        use_self_hit_prob=True, device=device,
        generator=torch.Generator().manual_seed(7))
    s = {k: v.to(device) for k, v in sample.items()}
    data = imgs_info.build_render_sample_mv(s, coords.to(device), [0, 1, 2],
                                            3)
    data["ref_imgs_info"]["mvs_depth"] = resize_linear(
        s["depth_panos"][[0, 1, 2]], (dh, dw), axes=(1, 2))
    data["que_imgs_info"]["mvs_depth"] = resize_linear(
        s["depth_panos"][[3]], (dh, dw), axes=(1, 2))
    cfg = trainer_mod.TrainerConfig(
        losses=("render", "depth", "consistency"), seed=7)
    opt, schedule = trainer_mod.make_optimizer(cfg, model.parameters())
    step = trainer_mod.make_train_step(lambda b, g: model(b, g), cfg, opt,
                                       schedule)
    fused_mlp.reset_launches()
    metrics = step(data, torch.Generator().manual_seed(7), 0)
    return (float(metrics["loss"]), {n: p.grad.detach().cpu() for n, p in
                                     model.named_parameters()},
            fused_mlp.MLP2_LAUNCHES, dict(fused_mlp.VARIANT_LAUNCHES))


def _ft_step(device: str, ft_state: dict, batch: dict) -> tuple:
    """One depth-guided ft step at 64x128 on ``device`` from ``ft_state``:
    (loss, grads, mlp2 launches, launches by variant)."""
    model = NeuralRayFtRenderer(rfn=2, ray_feats_hw=(8, 16), height=64,
                                width=128, depth_sample_num=32,
                                fine_depth_sample_num=32, device=device)
    model.load_state_dict(ft_state)
    opt = train_ft.make_optimizer(model, 1e-4, 1e-2)
    b = {k: {n: t.to(device) for n, t in v.items()} for k, v in batch.items()}
    fused_mlp.reset_launches()
    loss = train_ft.ft_step(model, opt, b, torch.Generator().manual_seed(9))
    return (float(loss), {n: p.grad.detach().cpu() for n, p in
                          model.named_parameters()},
            fused_mlp.MLP2_LAUNCHES, dict(fused_mlp.VARIANT_LAUNCHES))


def mv_ft_cuda_vs_cpu() -> None:
    """At 64x128 (depth 32x64, 32 + 32 samples, 512 rays off the seams),
    CUDA through the kernels against the CPU through the plain versions,
    same inputs, weights and sampling draws: one V = 4 training step with
    the consistency loss, and one depth-guided ft step (the ft renderer
    initialised on the CPU from a seeded gen renderer, the query a
    reference view, sigma 0.3).  The limits of ``train_cuda_vs_cpu``: loss
    within 1e-4 relative, each gradient within 1e-3 of its scale (plus the
    floor); 2 mlp2 launches on CUDA, all ``lanes``."""
    h, w, dh, dw = 64, 128, 32, 64
    rng = np.random.default_rng(7)
    sample = make_multi_view_sample(SphereScene.random(7), h, w, 4, 0.25,
                                    seed=7)
    coords = off_seam_coords(rng, 512, h, w)
    runs = {"mv_consistency": {d: _mv_step(d, sample, coords)
                               for d in ("cuda", "cpu")}}

    s3 = make_three_view_sample(SphereScene.random(9), h, w, 0.5, seed=9)
    gen = NeuralRayGenRenderer(height=h, width=w, depth_hw=(dh, dw),
                               depth_sample_num=32, fine_depth_sample_num=32,
                               device="cpu",
                               generator=torch.Generator().manual_seed(9))
    ft = NeuralRayFtRenderer(rfn=2, ray_feats_hw=(dh // 4, dw // 4),
                             height=h, width=w, device="cpu")
    data = imgs_info.build_render_sample(s3, coords, src_for_mvs=False)
    data["ref_imgs_info"]["mvs_depth"] = resize_linear(
        s3["depth_panos"][list(imgs_info.REF_IDS)], (dh, dw), axes=(1, 2))
    cache = init_ft_params_from_gen(ft, gen, data["ref_imgs_info"])
    c2w = imgs_info.c2w_from_w2c(imgs_info.pose_w2c(s3["rots"], s3["trans"]))
    batch = {"ref_imgs_info": {k: data["ref_imgs_info"][k] for k in
                               ("imgs", "w2c", "depth_range")},
             "que_imgs_info": {
                 "coords": coords, "c2w": c2w[0],
                 "depth_range": data["que_imgs_info"]["depth_range"],
                 "imgs": s3["rgb_panos"][:1],
                 "ft_depth_range": ft_depth_range_at_coords(
                     cache, 0, coords, h, w, 0.3)}}
    state = ft.state_dict()
    runs["ft_guided"] = {d: _ft_step(d, state, batch)
                         for d in ("cuda", "cpu")}
    for name, r in runs.items():
        (loss_c, grads_c, launches, variants), (loss_p, grads_p, _, _) = \
            r["cuda"], r["cpu"]
        share, floor = grad_limit_shares(grads_c, grads_p)
        bad = [n for n, v in share.items() if v > 1]
        loss_rel = abs(loss_c - loss_p) / abs(loss_p)
        emit({"phase": "mv_ft_cuda_vs_cpu", "step": name, "hw": [h, w],
              "depth_hw": [dh, dw], "samples": [32, 32], "rays": 512,
              "dtype": "float32", "loss_cuda": loss_c, "loss_cpu": loss_p,
              "loss_rel_err": loss_rel, "mlp2_launches_cuda": launches,
              "params": len(grads_p), "grad_worst_limit_share": sorted(
                  share.items(), key=lambda kv: -kv[1])[:5],
              "grad_abs_floor": floor, "params_over_limit": bad})
        assert_specialised(f"mv_ft_cuda_vs_cpu {name}", launches, variants)
        if launches != 2 or not loss_rel <= 1e-4 or bad:
            raise AssertionError(f"mv_ft_cuda_vs_cpu {name}: loss rel "
                                 f"{loss_rel}, launches {launches}, over "
                                 f"limit {bad}")


# ---------------------------------------------------------------------------
# the renderer's other modes: DINER, the light coarse pass, cube faces
# ---------------------------------------------------------------------------

MODES_CHUNK = 4096
RENDER_CUBES_OUT = "data/chip_smoke_render_cubes"
AB_OUT = "data/chip_smoke_ab"
# bench.py --diner: the serving flags with the coarse colour head, whose
# colours are the frame
DINER_FLAGS = dict(coarse_geometry_only=False)


def mode_frames() -> dict:
    """512x1024 frames at 4096-ray chunks from bench.py's inputs: DINER
    (the serving flags with the coarse colour head, coarse_lowres 1,
    mvs_uncert 0.04) from 128 candidates, then with a 64-sample uniform
    pass merged, and a light-coarse frame (serving flags).  One mlp2
    launch per chunk pass: 128, 256 and 128 a frame.  Then a profile of
    DINER chunks.  Returns {run: mlp2 launches}."""
    ref_info, c2w, qdr = bench.bench_inputs(H, W, DH, DW)
    dr = ref_info["depth_range"]
    n_chunks = H * W // MODES_CHUNK
    diner = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW),
        **preset_kwargs("serving", **DINER_FLAGS), device="cuda",
        generator=torch.Generator().manual_seed(0))
    ref = full_render.prepare_ref_data(diner, ref_info)
    ref["mvs_uncert"] = torch.full_like(ref["mvs_depth"], 0.04)
    light = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW), light_coarse=True,
        **preset_kwargs("serving"), device="cuda",
        generator=torch.Generator().manual_seed(0))
    ref_light = full_render.prepare_ref_data(light, ref_info)
    meta = {"chunk": MODES_CHUNK, "dtype": "bfloat16", "samples": 64}
    runs = {
        "diner": (diner, ref, dict(mode="diner", n_candidates=128),
                  n_chunks),
        "diner_mu64": (diner, ref, dict(mode="diner", n_candidates=128,
                                        n_uniform=64), 2 * n_chunks),
        "light_coarse": (light, ref_light, {}, n_chunks)}
    launches = {}
    for run, (model, rd, kw, expected) in runs.items():
        row, _ = frame_run("mode_frame", run, lambda: full_render
                           .render_image_device(model, rd, c2w, qdr, dr,
                                                chunk=MODES_CHUNK, **kw),
                           expected, {**meta, **kw})
        launches[run] = row["mlp2_launches"]
    # the sampler's operators (topk, sort, erf) over 4 DINER chunks
    c2w_t, qdr_t, dr_t = cuda_f32(c2w, qdr, dr)
    coords = imgs_info.full_image_coords(H, W, torch.device("cuda")).reshape(
        -1, 1, MODES_CHUNK, 2)[n_chunks // 2:][:4]

    def run():
        for c in coords:
            diner.render_rays_diner(ref, c, c2w_t, qdr_t, dr_t)
    profile_chunks("mode_profile", f"4 DINER chunks of {MODES_CHUNK} rays",
                   run, 4, ops=("aten::topk", "aten::sort", "aten::erf",
                                "aten::cumprod"))
    return launches


def render_cubes_cli() -> int:
    """``tools.render_cubes`` at 512x1024 (depth 256x512): 1 scene, the
    query view's 6 faces of 256x256, the renderer's exact flags, 4096-ray
    chunks: finite per-face metrics and 6 x 16 chunks x 2 passes = 192
    mlp2 launches, all ``lanes``.  Returns the launches."""
    fused_mlp.reset_launches()
    t0 = time.perf_counter()
    summary = render_cubes.main(["--height", str(H), "--width", str(W),
                                 "--depth-height", str(DH), "--depth-width",
                                 str(DW), "--num", "1", "--out",
                                 RENDER_CUBES_OUT, "--device", "cuda"])
    seconds = time.perf_counter() - t0
    count, count3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
    variants = dict(fused_mlp.VARIANT_LAUNCHES)
    expected = 6 * -(-(H // 2) ** 2 // render_cubes.CHUNK) * 2
    emit({"phase": "render_cubes", "hw": [H, W], "depth_hw": [DH, DW],
          "face_w": H // 2, "chunk": render_cubes.CHUNK, "faces": 6,
          "mlp2_launches": count, "mlp3_launches": count3,
          "variant_launches": variants, "cli_seconds": seconds,
          "sec_per_face": summary["sec_per_face"], "mean": summary["mean"],
          "faces_psnr": [f["psnr_nr"] for f in summary["faces"]]})
    if len(summary["faces"]) != 6 or not all(
            np.isfinite(v) for f in summary["faces"] for v in f.values()):
        raise AssertionError(f"render_cubes: {summary}")
    if count != expected or count3:
        raise AssertionError(f"render_cubes: mlp2 launched {count} times, "
                             f"expected {expected}; mlp3 {count3}")
    assert_specialised("render_cubes", count, variants)
    return count


def ab_quality_cli() -> dict:
    """``tools.ab_quality`` at 512x1024 (depth 256x512): a renderer trained
    from scratch under DINER (``--train-mode diner``, no fine heads; 1
    warm-up and 5 timed steps through ``timed_training``: one mlp2 launch
    a step, every parameter moved), then the held-out scene's table under
    ``diner`` and ``diner_mu64`` (2048-ray chunks: 256 and 512 launches):
    finite PSNR / SSIM.  Returns {what: mlp2 launches}."""
    argv = ["--height", str(H), "--width", str(W), "--depth-height",
            str(DH), "--depth-width", str(DW), "--train-mode", "diner",
            "--steps", str(TRAIN_STEPS), "--num", "1", "--device", "cuda"]
    args = ab_quality.parse_args(argv)
    built = {}

    def build(on_step):
        built["make"], built["model"], trainer, built["stream"] = \
            ab_quality.build(args, on_step)
        trainer.cfg.log_interval = 1          # every step reaches on_step
        return trainer

    def finish(trainer):
        if any(k.startswith("fine_") for k in trainer.model.state_dict()):
            raise AssertionError("ab_quality: a DINER model has fine heads")
        table, launches = {}, {}
        for mode, expected in (("diner", H * W // 2048),
                               ("diner_mu64", 2 * H * W // 2048)):
            args.modes = mode
            fused_mlp.reset_launches()
            t0 = time.perf_counter()
            table.update(ab_quality.evaluate(args, built["make"],
                                             trainer.model.state_dict()))
            launches[mode] = {"mlp2": fused_mlp.MLP2_LAUNCHES,
                              "seconds": time.perf_counter() - t0,
                              "variants": dict(fused_mlp.VARIANT_LAUNCHES)}
            if fused_mlp.MLP2_LAUNCHES != expected or \
                    fused_mlp.MLP3_LAUNCHES:
                raise AssertionError(f"ab_quality {mode}: mlp2 launched "
                                     f"{fused_mlp.MLP2_LAUNCHES}, expected "
                                     f"{expected}")
            assert_specialised(f"ab_quality {mode}", expected,
                               launches[mode]["variants"])
        if not all(np.isfinite(v) for m in table.values()
                   for v in m.values()):
            raise AssertionError(f"ab_quality: {table}")
        return {"table": table, "eval": launches}

    _, row, _ = timed_training(
        "ab_quality_train", build,
        lambda t: t.fit(built["stream"], TRAIN_STEPS),
        lambda t: t.model.state_dict().items(), finish,
        {"hw": [H, W], "depth_hw": [DH, DW], "train_mode": "diner",
         "samples": 64, "candidates": 128, "rays": 512},
        launches_per_step=1)
    return {"train_per_step": row["mlp2_launches_per_step"][-1],
            **{m: v["mlp2"] for m, v in row["eval"].items()}}


def _cube_face_cam(c2w: np.ndarray, face: int, fw: int) -> tuple:
    """(w2c (1, 3, 4), K (1, 3, 3)) of cube face ``face`` of the panorama
    camera ``c2w``, as ``PanoDatabase.cube_cameras`` gives them."""
    rot = c2w[:, :3].T
    trans = -rot @ c2w[:, 3]
    db = PanoDatabase("m3d", np.zeros((1, fw, 2 * fw, 3)),
                      np.zeros((1, fw, 2 * fw, 1)), rot[None], trans[None])
    w2c, k = db.cube_cameras(0)
    return w2c[face:face + 1], k[None]


def diner_ambiguous_pixels(model, ref_info: dict, c2w, n_candidates: int,
                           h: int, w: int) -> torch.Tensor:
    """(h, w) pixels whose DINER samples float rounding may change
    (``diner.ambiguous_rays`` on a float64 evaluation on the CPU)."""
    f64 = lambda t: torch.as_tensor(np.asarray(t), dtype=torch.float64)
    coords = imgs_info.full_image_coords(h, w).double()
    cand = render_ops.sample_depth(1, h * w, n_candidates, model.min_depth,
                                   model.max_depth, False)[0].double()
    pts, _ = render_ops.depth2points_spherical(
        coords, cand, f64(c2w), model.directions.cpu().double())
    depth = f64(ref_info["mvs_depth"])
    prj = diner_mod.project_depth_info(
        {"imgs": f64(ref_info["imgs"]), "w2c": f64(ref_info["w2c"]),
         "mvs_depth": depth, "mvs_uncert": torch.full_like(depth, 0.04)},
        pts, model.convention)
    return diner_mod.ambiguous_rays(
        cand, prj, model.depth_sample_num, 8, model.min_depth,
        model.max_depth)[0].reshape(h, w)


def modes_cuda_vs_cpu() -> None:
    """At 64x128 (depth 32x64, 64 + 64 samples, float32), the same seeded
    model and inputs on CUDA through the kernels and on the CPU through
    the plain versions, each within the frame limit of 2e-3: a DINER frame
    (128 candidates), a light-coarse frame, a perspective cube face (exact
    flags, 32x32), a frame with the nearest merged-map gather and a frame
    with the vis heads (both serving flags, coarse pass at half
    resolution).

    Pixels where the output is discontinuous in rounding are counted and
    left out, at most 6% of a frame (the largest share measured on the
    H100 is 5%): those whose CPU output moves by more than the limit when
    the query pose moves by 1e-6 or by 1e-7 (the cameras sit on one axis,
    so there a ray's points lie on a view's longitude seam, where the
    branch taken can change over a 1e-7 move and not over 1e-6; nearest
    taps that flip; fine samples in near-empty bins), and for DINER also
    those whose candidates' selection a float64 evaluation flags
    (``diner.ambiguous_rays``).  The error over all pixels and the
    unflagged pixels over the limit are reported too.  Then one DINER
    training step (``diner_step_cuda_vs_cpu``)."""
    h, w, dh, dw = 64, 128, 32, 64
    ref_info, c2w, qdr = bench.bench_inputs(h, w, dh, dw)
    dr = ref_info["depth_range"]
    serving = preset_kwargs("serving", compute_dtype="float32")
    fw = h // 2
    ys, xs = torch.meshgrid(torch.arange(fw), torch.arange(fw),
                            indexing="ij")
    face_coords = torch.stack([xs, ys], -1).reshape(1, -1, 2).float()
    w2c_face, k_face = _cube_face_cam(c2w, 0, fw)

    def frame(kw):
        def run(model, ref, device, shift):
            pose = c2w.copy()
            pose[:, 3] += shift
            return full_render.render_image_device(
                model, ref, pose, qdr, dr, device=device, **kw)
        return run

    def face(model, ref, device, shift):
        pose = w2c_face[0].copy()
        pose[:, 3] += shift
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return render_cubes.render_face(model, ref, face_coords.to(device),
                                        t(pose), t(k_face[0]), t(qdr), t(dr),
                                        fw)

    cases = {
        "diner": (dict(serving, **DINER_FLAGS),
                  frame(dict(mode="diner", n_candidates=128, chunk=256))),
        "light_coarse": (dict(serving, light_coarse=True),
                         frame(dict(chunk=256))),
        "perspective": (preset_kwargs("exact"), face),
        "gather_nearest": (dict(serving, gather_nearest=True),
                           frame(dict(chunk=256, coarse_lowres=2))),
        "use_vis": (dict(serving, use_vis=True),
                    frame(dict(chunk=256, coarse_lowres=2)))}
    for name, (flags, run) in cases.items():
        out, launches = {}, 0
        for device in ("cuda", "cpu"):
            model = NeuralRayGenRenderer(
                height=h, width=w, depth_hw=(dh, dw), **flags, device=device,
                generator=torch.Generator().manual_seed(3))
            ref = full_render.prepare_ref_data(model, ref_info,
                                               device=device)
            ref["mvs_uncert"] = torch.full_like(ref["mvs_depth"], 0.04)
            fused_mlp.reset_launches()
            out[device] = run(model, ref, device, 0.0).cpu()
            if device == "cuda":
                launches = fused_mlp.MLP2_LAUNCHES
                assert_specialised(f"modes_cuda_vs_cpu {name}", launches,
                                   fused_mlp.VARIANT_LAUNCHES)
        diff = (out["cuda"] - out["cpu"]).abs().amax(-1)
        flagged = torch.zeros_like(diff, dtype=torch.bool)
        for shift in (1e-6, -1e-6, 1e-7, -1e-7):
            moved = (run(model, ref, "cpu", shift) - out["cpu"]).abs()
            flagged |= moved.amax(-1) > 2e-3
        witnessed = int(flagged.sum())
        if name == "diner":
            flagged |= diner_ambiguous_pixels(model, ref_info, c2w, 128, h, w)
        held = torch.where(flagged, 0.0, diff)
        err = held.max().item()
        over = torch.nonzero(held > 2e-3)
        emit({"phase": "modes_cuda_vs_cpu", "case": name,
              "hw": list(diff.shape), "dtype": "float32",
              "mlp2_launches_cuda": launches, "max_abs_err_rgb": err,
              "pixels_flagged": int(flagged.sum()),
              "pixels_flagged_by_pose_shift": witnessed,
              "pixels": diff.numel(),
              "unflagged_over_limit_yx": over[:20].tolist(),
              "worst_unflagged_yx": divmod(int(held.argmax()),
                                           diff.shape[1]),
              "max_abs_err_rgb_all_pixels": diff.max().item(),
              "pixels_over_limit_all": int((diff > 2e-3).sum()),
              "rgb_std": out["cpu"].std().item()})
        if launches == 0 or not err <= 2e-3 or flagged.float().mean() > 0.06:
            raise AssertionError(f"modes_cuda_vs_cpu {name}: err {err}, "
                                 f"launches {launches}, flagged "
                                 f"{int(flagged.sum())}")
    diner_step_cuda_vs_cpu(h, w, dh, dw)


def diner_step_cuda_vs_cpu(h: int, w: int, dh: int, dw: int) -> None:
    sample = make_three_view_sample(SphereScene.random(8), h, w, 0.5, seed=8)
    coords = off_seam_coords(np.random.default_rng(8), 256, h, w)
    cfg = trainer_mod.TrainerConfig(losses=("render", "depth"), seed=8)
    results = {}
    for device in ("cuda", "cpu"):
        model = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=(dh, dw), depth_sample_num=16,
            sampling_mode="diner", use_hierarchical_sampling=False,
            diner_n_candidates=64, diner_n_uniform=8,
            gather_depth_major=True, device=device,
            generator=torch.Generator().manual_seed(8))
        s = {k: v.to(device) for k, v in sample.items()}
        data = imgs_info.build_render_sample(s, coords.to(device),
                                             src_for_mvs=False)
        data["ref_imgs_info"]["mvs_depth"] = resize_linear(
            s["depth_panos"][list(imgs_info.REF_IDS)], (dh, dw), axes=(1, 2))
        opt, schedule = trainer_mod.make_optimizer(cfg, model.parameters())
        step = trainer_mod.make_train_step(lambda b, g: model(b, g), cfg,
                                           opt, schedule)
        fused_mlp.reset_launches()
        metrics = step(data, torch.Generator().manual_seed(8), 0)
        launches, variants = fused_mlp.MLP2_LAUNCHES, dict(
            fused_mlp.VARIANT_LAUNCHES)
        results[device] = (float(metrics["loss"]),
                           {n: p.grad.detach().cpu()
                            for n, p in model.named_parameters()}, launches,
                           variants)
    (loss_c, grads_c, launches, variants), (loss_p, grads_p, _, _) = \
        results.values()
    share, floor = grad_limit_shares(grads_c, grads_p)
    bad = [n for n, v in share.items() if v > 1]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    emit({"phase": "modes_cuda_vs_cpu", "case": "diner_train_step",
          "hw": [h, w], "depth_hw": [dh, dw], "samples": 16,
          "candidates": 64, "n_uniform": 8, "rays": 256, "dtype": "float32",
          "loss_cuda": loss_c, "loss_cpu": loss_p, "loss_rel_err": loss_rel,
          "mlp2_launches_cuda": launches, "params": len(grads_p),
          "grad_worst_limit_share": sorted(share.items(),
                                           key=lambda kv: -kv[1])[:5],
          "grad_abs_floor": floor, "params_over_limit": bad})
    assert_specialised("modes_cuda_vs_cpu diner step", launches, variants)
    if launches != 2 or not loss_rel <= 1e-4 or bad:
        raise AssertionError(f"modes_cuda_vs_cpu diner step: loss rel "
                             f"{loss_rel}, launches {launches}, over limit "
                             f"{bad}")


# ---------------------------------------------------------------------------
# depth-net variants
# ---------------------------------------------------------------------------

VARIANT_COMMON = ["--steps", str(DEPTH_STEPS), "--log-interval", "1",
                  "--vis-interval", "0", "--device", "cuda"]
VARIANT_RUNS = {
    # phase: (tool, flags, BatchNorm statistics to move)
    "variant_train_mono_erp_tp": (train_mono, [
        "--mono-net", "ERP+TP", "--nrows", "4", "--patch-size", "64",
        "--height", str(H), "--width", str(W), "--batch", "2", "--name",
        "chip_smoke_erp_tp"], True),
    "variant_train_mono_mobilenet": (train_mono, [
        "--num-layers", "2", "--height", str(H), "--width", str(W),
        "--batch", "2", "--name", "chip_smoke_mobilenet"], True),
    "variant_train_mvs_costregnet": (train_depth, [
        "--cfg", MVS_CFG, "--new-reg3dnet", "--name",
        "chip_smoke_costregnet"], True),
    "variant_train_fnet": (train_depth, [
        "--cfg", MVS_CFG, "--model", "fnet", "--name", "chip_smoke_fnet"],
        False)}
FEATURE_NETS = {"Equi": {}, "ERP+TP": dict(feature_net_type="ERP+TP"),
                "TP": dict(feature_net_type="TP"),
                "Cube": dict(feature_net_type="Cube"),
                "with_sin": dict(with_sin=True)}


def variant_training() -> int:
    """Each new recipe through its CLI's ``build``/``fit``/``save``
    (``depth_train_cli``): ERP+TP mono (4 rows of 64-pixel patches) and
    UniFuse on MobileNetV2 at 512x1024, batch 2; ``m3d_mvs.yaml`` with
    CostRegNet on a random mono prior, and with FNET (64 inverse-uniform
    depths, the cost volume at the full 256x512).  Returns the MLP
    kernels' launches over the four runs (0 asserted by each)."""
    launches = 0
    for phase, (tool, flags, bn) in VARIANT_RUNS.items():
        _, _, _, m2, m3 = depth_train_cli(phase, tool,
                                          [*flags, *VARIANT_COMMON],
                                          expect_bn=bn)
        launches += m2 + m3
    return launches


def feature_net_forwards() -> None:
    """One forward of MVSDepthModel at the m3d_mvs shape (256x512, batch
    2 of 2 views, 64 hypotheses, the UNet3D of base 32; mono depth and
    features of a random prior at 256x512) with each feature net, the
    shipped Equi beside them: ms (median of 3 after a warm-up), peak
    memory, the depth finite and of its shape, no MLP launch."""
    s = make_three_view_sample(SphereScene.random(9, device="cuda"), DH,
                               DW, 1.0, seed=9)
    g = torch.Generator(device="cuda").manual_seed(9)
    args = (s["rgb_panos"][None, :2].repeat(2, 1, 1, 1, 1),
            s["rots"][None, :2].repeat(2, 1, 1, 1),
            s["trans"][None, :2].repeat(2, 1, 1),
            1.0 + 5.0 * torch.rand(2, DH, DW, 1, device="cuda", generator=g),
            torch.randn(2, DH // 2, DW // 2, 32, device="cuda", generator=g))
    for name, kw in FEATURE_NETS.items():
        model = tmvs.MVSDepthModel(**kw)
        tblocks.init_parameters_(model, torch.Generator().manual_seed(0))
        model.to("cuda").eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fused_mlp.reset_launches()
        with torch.inference_mode():
            out = model(*args)
            ms, runs = timed_ms(lambda: model(*args))
        depth = out["depth"]
        emit({"phase": "variant_feature_net", "feature_net": name, **kw,
              "hw": [DH, DW], "batch": 2, "views": 2, "hypotheses": 64,
              "dtype": "float32", "ms_per_forward": ms,
              "ms_per_forward_runs": runs,
              "peak_mem_bytes": torch.cuda.max_memory_allocated() - base,
              "params": sum(p.numel() for p in model.parameters()),
              "depth_mean": depth.mean().item(),
              "mlp2_launches": fused_mlp.MLP2_LAUNCHES,
              "mlp3_launches": fused_mlp.MLP3_LAUNCHES})
        if tuple(depth.shape) != (2, DH, DW, 1) or \
                not torch.isfinite(depth).all():
            raise AssertionError(f"variant_feature_net {name}: depth "
                                 f"{tuple(depth.shape)}")
        if fused_mlp.MLP2_LAUNCHES or fused_mlp.MLP3_LAUNCHES:
            raise AssertionError(f"variant_feature_net {name}: MLP kernels "
                                 "launched")


ERP_TP_FLAGS = dict(local_feature_type="ERP+TP",
                    init_net_feature_type="ERP+TP", nrows=4, patch_size=64)


def erp_tp_frame() -> int:
    """A 512x1024 frame of the renderer with both encoders ERP+TP (4 rows
    of 64-pixel patches; the serving preset, bench.py's inputs) at
    4096-ray chunks: ``prepare_ref`` ms (first call and median of 3), then
    ``frame_run``: 160 mlp2 launches, all ``lanes``, no mlp3.  Returns the
    mlp2 launches of the frame."""
    model = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW), **preset_kwargs("serving"),
        **ERP_TP_FLAGS, device="cuda",
        generator=torch.Generator().manual_seed(0))
    ref_info, c2w, qdr = bench.bench_inputs(H, W, DH, DW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = full_render.prepare_ref_data(model, ref_info)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    prep_ms, prep_runs = timed_ms(
        lambda: full_render.prepare_ref_data(model, ref_info))
    f = PRESET_COARSE_LOWRES["serving"]
    chunk = MODES_CHUNK
    expected = H * W // chunk + (H // f) * (W // f) // chunk
    row, _ = frame_run(
        "erp_tp_frame", "serving", lambda: full_render.render_image_device(
            model, ref, c2w, qdr, ref_info["depth_range"], chunk=chunk,
            coarse_lowres=f), expected,
        {**ERP_TP_FLAGS, "chunk": chunk, "coarse_lowres": f,
         "dtype": "bfloat16", "samples": [64, 64],
         "prepare_ref_first_ms": first_ms, "prepare_ref_ms": prep_ms,
         "prepare_ref_ms_runs": prep_runs})
    return row["mlp2_launches"]


def _variant_step(device: str, variant: str,
                  dtype: torch.dtype = torch.float32) -> dict:
    """One small training step (``_seeded_step``) of a variant: the ERP+TP
    mono net (4 rows of 32-pixel patches) and UniFuse on MobileNetV2 at
    64x128; FNET (16 depths) and the MVS net with CostRegNet, each other
    feature net or ``with_sin`` on ``_small_depth_step``'s MVS batch at
    32x64."""
    g = torch.Generator().manual_seed(11)
    if variant.startswith("mono"):
        s = make_three_view_sample(SphereScene.random(11), 64, 128, 0.5,
                                   seed=11)
        equi = tunifuse.normalize_imagenet(s["rgb_panos"][:2])
        batch = {"equi": equi, "gt_depth": torch.clamp(
            s["depth_panos"][:2], 0, 10)}
        if variant == "mono_erp_tp":
            model = tunifuse.ERPTPDepth(nrows=4, patch_size=32)

            def forward(b):
                return model(b["equi"])
        else:
            model = tunifuse.UniFuse(num_layers=2)
            batch["cube"] = cubemap.equi_to_cube(equi, 32)

            def forward(b):
                return model(b["equi"], b["cube"])
        return _seeded_step(model, forward, batch, device, dtype, g, False)
    # the MVS batch of _small_depth_step, views off each other's seam
    s = make_three_view_sample(SphereScene.random(12), 32, 64, 1.0, seed=12)
    trans = s["trans"] + torch.tensor(
        [[0.11, -0.04, 0.0], [-0.07, 0.05, 0.0], [0.03, 0.09, 0.0]])
    batch = {"panos": s["rgb_panos"][None, :2].repeat(2, 1, 1, 1, 1),
             "rots": s["rots"][None, :2].repeat(2, 1, 1, 1),
             "trans": trans[None, :2].repeat(2, 1, 1),
             "gt_depth": torch.clamp(s["depth_panos"][1:2], 0, 10)
             .repeat(2, 1, 1, 1)}
    if variant == "fnet":
        model = tfnet.FNetDepthModel(num_depths=16)

        def forward(b):
            return {"pred_depth": model(b["panos"], b["rots"],
                                        b["trans"])["depth"]}
        return _seeded_step(model, forward, batch, device, dtype, g, False)
    mono_depth = resize_linear(s["depth_panos"][1:2], (64, 128),
                               axes=(1, 2))
    batch["mono_depth"] = mono_depth * torch.tensor([0.9, 1.1])[
        :, None, None, None]
    batch["mono_feat"] = torch.randn(2, 32, 64, 32, generator=g)
    kw = (dict(use_new_reg3dnet=True) if variant == "mvs_costregnet"
          else FEATURE_NETS[variant[4:]])
    if kw.get("feature_net_type") in ("ERP+TP", "TP"):
        kw = dict(kw, patch_size=32)
    model = tmvs.MVSDepthModel(num_hypotheses=8, magnet_num_samples=3,
                               cnn3d_base=8, **kw)

    def forward(b):
        out = model(*(b[k] for k in ("panos", "rots", "trans", "mono_depth",
                                     "mono_feat")))
        out["pred_depth"] = out.pop("depth")
        return out
    return _seeded_step(model, forward, batch, device, dtype, g, True)


VARIANT_STEPS = ("mono_erp_tp", "mono_mobilenet", "mvs_costregnet", "fnet",
                 "mvs_ERP+TP", "mvs_TP", "mvs_Cube", "mvs_with_sin")


def variant_cuda_vs_cpu() -> None:
    """Each variant's small step (``_variant_step``) on CUDA against the
    CPU, float32, TF32 off, within ``compare_steps``'s limits (the CPU
    step in float64 tells float32 rounding of an ill-conditioned gradient
    from the card's); then the ERP+TP renderer's 64x128 serving frame
    (float32) on CUDA against the CPU within 2e-3."""
    for variant in VARIANT_STEPS:
        cu, cp, cp64 = (_variant_step(d, variant, t) for d, t in (
            ("cuda", torch.float32), ("cpu", torch.float32),
            ("cpu", torch.float64)))
        compare_steps("variant_cuda_vs_cpu", {"variant": variant}, cu, cp,
                      cp64)
    h, w, dh, dw = 64, 128, 32, 64
    ref_info, c2w, qdr = bench.bench_inputs(h, w, dh, dw)
    rgbs = {}
    for device in ("cuda", "cpu"):
        model = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=(dh, dw),
            **preset_kwargs("serving", compute_dtype="float32"),
            **dict(ERP_TP_FLAGS, patch_size=32), device=device,
            generator=torch.Generator().manual_seed(1))
        ref = full_render.prepare_ref_data(model, ref_info, device=device)
        fused_mlp.reset_launches()
        rgbs[device] = full_render.render_image_device(
            model, ref, c2w, qdr, ref_info["depth_range"], chunk=256,
            coarse_lowres=2, device=device).cpu()
        if device == "cuda":
            launches = fused_mlp.MLP2_LAUNCHES
            assert_specialised("variant_cuda_vs_cpu erp_tp frame", launches,
                               fused_mlp.VARIANT_LAUNCHES)
    err = (rgbs["cuda"] - rgbs["cpu"]).abs().max().item()
    emit({"phase": "variant_cuda_vs_cpu", "variant": "erp_tp_frame",
          "hw": [h, w], "dtype": "float32", "mlp2_launches_cuda": launches,
          "max_abs_err_rgb": err, "rgb_std": rgbs["cpu"].std().item()})
    if launches == 0 or not err <= 2e-3:
        raise AssertionError(f"variant_cuda_vs_cpu erp_tp frame: err {err},"
                             f" launches {launches}")


def cube_encoder_float64_check() -> None:
    """The depth-training check's open question: the mono recipe's small
    step (``_small_depth_step``) on CUDA in float32, on the CPU in float32
    and on the CPU in float64.  For each cube-encoder parameter, the
    largest element error of the CUDA and the CPU float32 gradients
    against float64 (relative to the parameter's largest float64
    gradient), and where the CUDA-CPU difference peaks.  The verdict is
    float32 rounding where the CUDA gradient is no further from float64
    than twice the CPU's plus 1e-4, else the port's."""
    cu, cp, cp64 = (_small_depth_step(d, "mono", t) for d, t in (
        ("cuda", torch.float32), ("cpu", torch.float32),
        ("cpu", torch.float64)))
    rows = []
    for k, exact in cp64["grads"].items():
        if not k.startswith("cube_encoder."):
            continue
        scale = max(exact.abs().max().item(), 1e-30)
        diff = (cu["grads"][k] - cp["grads"][k]).abs()
        rows.append({"param": k, "shape": list(exact.shape),
                     "cuda_vs_cpu": diff.max().item() / scale,
                     "cuda_vs_f64": (cu["grads"][k] - exact).abs().max()
                     .item() / scale,
                     "cpu_vs_f64": (cp["grads"][k] - exact).abs().max()
                     .item() / scale,
                     "at": [int(i) for i in np.unravel_index(
                         int(diff.argmax()), tuple(exact.shape))]})
    rows.sort(key=lambda r: -r["cuda_vs_cpu"])
    worst = rows[0]
    verdict = ("float32 rounding" if worst["cuda_vs_f64"]
               <= 2 * worst["cpu_vs_f64"] + 1e-4 else "port")
    emit({"phase": "cube_encoder_float64", "recipe": "mono (UniFuse, "
          "64x128, batch 2)", "worst": rows[:5], "verdict": verdict,
          "loss": {"cuda": cu["loss"], "cpu": cp["loss"],
                   "cpu_f64": cp64["loss"]}})


# ---------------------------------------------------------------------------
# the data pipeline: shards, the LMDB import and --shards in the CLIs
# ---------------------------------------------------------------------------

DATA_RUNS = Path("data/chip_smoke_data")
# the reference writer's name scheme: mode, width x height, views, spacing
LMDB_ENV = f"lmdb_render_train_{W}x{H}_seq_len_3_m3d_dist_0.5"


def prepare_shards(phase: str, out: Path, argv: list, num: int) -> dict:
    """``tools.prepare_data`` writing ``num`` samples to ``out`` on the
    card, 64 a shard: seconds per sample, the shards' sizes, and the keys
    and dtypes of the first shard (the JAX package's schema)."""
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = prepare_data.main(["--out", str(out), "--num", str(num),
                                 "--device", "cuda", *argv])
    seconds = time.perf_counter() - t0
    shards = sorted(out.glob("shard_*.npz"))
    with np.load(shards[0]) as z:
        schema = {k: [list(z[k].shape), str(z[k].dtype)] for k in z.files}
    row = {"phase": phase, "argv": argv, "samples": written,
           "seconds": seconds, "s_per_sample": seconds / num,
           "shards": len(shards),
           "bytes_per_shard": [p.stat().st_size for p in shards],
           "schema": schema}
    emit(row)
    want = {k: "float16" if k in shards_mod.ShardWriter.F16_KEYS
            else "float32" for k in schema}
    if written != num or len(shards) != -(-num // 64) or \
            {k: v[1] for k, v in schema.items()} != want or \
            any(v[0][0] != min(num, 64) for v in schema.values()):
        raise AssertionError(f"{phase}: {row}")
    return row


def lmdb_import_check(cube_dir: Path) -> dict:
    """A 2-sample, seq_len 3 LMDB env written by ``write_minimal_lmdb``
    from the online generator's 512x1024 cube samples (rendered on the
    card), named by the reference scheme, imported through the
    ``import_lmdb`` CLI with the geometry parsed from the name; the shard
    must equal the float16 / float32 casts of what was written."""
    gen = OnlineImageGenerator("train", H, W, seq_len=3, m3d_dist=0.5,
                               with_cubes=True, seed=5, device="cuda")
    samples = [gen[i] for i in range(2)]
    env = cube_dir.parent / LMDB_ENV
    shutil.rmtree(env, ignore_errors=True)
    t0 = time.perf_counter()
    lmdb_reader.write_minimal_lmdb(env, {
        f"{i},{k}".encode("ascii"): np.ascontiguousarray(v, np.float32)
        .tobytes() for i, s in enumerate(samples) for k, v in s.items()})
    write_s = time.perf_counter() - t0
    out = cube_dir.parent / "imported"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    n = import_lmdb.main(["--env", str(env), "--out", str(out)])
    import_s = time.perf_counter() - t0
    with np.load(out / shards_mod.SHARD_FMT.format(0)) as z:
        got = {k: z[k] for k in z.files}
    bad = []
    for k in samples[0]:
        dt = np.float16 if k in shards_mod.ShardWriter.F16_KEYS \
            else np.float32
        want = np.stack([s[k] for s in samples]).astype(dt)
        if k not in got or got[k].dtype != want.dtype or \
                not np.array_equal(got[k], want):
            bad.append(k)
    row = {"phase": "lmdb_import", "env": LMDB_ENV,
           "parsed": lmdb_import.parse_env_name(env), "samples": n,
           "env_bytes": (env / "data.mdb").stat().st_size,
           "write_seconds": write_s, "import_seconds": import_s,
           "keys": sorted(got), "mismatched": bad}
    emit(row)
    if n != 2 or bad or row["parsed"] != {
            "mode": "train", "width": W, "height": H, "seq_len": 3,
            "m3d_dist": 0.5}:
        raise AssertionError(f"lmdb_import: {row}")
    return row


def reader_timing(shard_dir: Path) -> dict:
    """``ShardReader``'s host ms per sample on the 256-sample 512x1024
    directory (4 shards of 64): 64 reads at the sample indices that
    ``train_mono``'s generator draws, split into the reads that map a
    shard (the reader keeps 3, so most draws after the first few shards
    map one again) and the others, the median of each; beside them two
    reads of a sample the way an ``NpzFile`` gives it (every key's member
    of the 64-sample shard decoded whole), as the JAX reader does."""
    reader = shards_mod.ShardReader(shard_dir)
    idx = np.random.default_rng(2022).integers(len(reader), size=64)
    mapping, mapped = [], []
    for i in idx:
        fresh = int(i) // reader.sps not in reader._cache
        t0 = time.perf_counter()
        s = reader[int(i)]
        (mapping if fresh else mapped).append(
            (time.perf_counter() - t0) * 1e3)
    npz_ms = []
    for i in idx[:2]:
        si, off = divmod(int(i), reader.sps)
        t0 = time.perf_counter()
        with np.load(shard_dir / shards_mod.SHARD_FMT.format(si)) as z:
            {k: np.asarray(z[k][off], np.float32) for k in z.files}
        npz_ms.append((time.perf_counter() - t0) * 1e3)
    row = {"phase": "shard_reader", "samples": len(reader),
           "shards": reader.num_shards, "samples_per_shard": reader.sps,
           "reads": len(idx), "reads_mapping_a_shard": len(mapping),
           "ms_per_sample_mapping_a_shard": statistics.median(mapping),
           "ms_per_sample": statistics.median(mapped),
           "ms_runs_mapping": mapping, "ms_runs": mapped,
           "npzfile_ms_per_sample": statistics.median(npz_ms),
           "npzfile_ms_runs": npz_ms,
           "sample_bytes": int(sum(v.nbytes for v in s.values())),
           "shard_bytes": (shard_dir / shards_mod.SHARD_FMT.format(0))
           .stat().st_size}
    emit(row)
    if not all(s[k].dtype == np.float32 for k in s) or \
            s["rgb_panos"].shape != (3, H, W, 3) or len(mapping) < 4:
        raise AssertionError(f"shard_reader: {row}")
    return row


def shard_training(shards: Path, mvs_shards: Path, pool_ms) -> dict:
    """``train_renderer --shards`` on TRAIN_CFG (a derived yaml of its own
    name, so that the training group's checkpoint stays) through
    ``train_cli``, 2 mlp2 launches per step asserted, its ms/step beside
    the pool's from the training group; then ``train_mono --shards`` on
    the mono recipe and ``train_depth --shards`` on MVS_CFG (from the
    256x512 shards, on the mono run's checkpoint) through
    ``depth_train_cli``: every parameter and BatchNorm statistic moved, no
    MLP kernel launched.  Returns the renderer's checkpoint and the
    launches."""
    cfg = yaml.safe_load(Path(TRAIN_CFG).read_text())
    cfg.update(name="chip_smoke_shards")
    path = DATA_RUNS / "train_shards.yaml"
    path.write_text(yaml.safe_dump(cfg))
    trainer, _, row, _ = train_cli(
        "train_shards", ["--cfg", str(path), "--shards", str(shards)],
        {"cfg": TRAIN_CFG, "shards": str(shards), "hw": [H, W],
         "depth_hw": [DH, DW], "samples": [64, 64], "rays": 512,
         "pool_ms_per_step": pool_ms})
    ckpt = trainer.ckpt_path("latest")
    del trainer
    common = ["--steps", str(DEPTH_STEPS), "--log-interval", "1",
              "--vis-interval", "0", "--device", "cuda"]
    _, _, mono_ckpt, m2a, m3a = depth_train_cli(
        "train_mono_shards", train_mono,
        ["--shards", str(shards), "--height", str(H), "--width", str(W),
         "--batch", "2", "--name", "chip_smoke_shards_mono", *common])
    _, _, _, m2b, m3b = depth_train_cli(
        "train_depth_shards", train_depth,
        ["--cfg", MVS_CFG, "--shards", str(mvs_shards), "--mono-ckpt",
         str(mono_ckpt), "--name", "chip_smoke_shards_mvs", *common])
    return {"ckpt": ckpt, "per_step": row["mlp2_launches_per_step"][-1],
            "mlp3": sum(row["mlp3_launches_per_step"]) + m3a + m3b,
            "depth_mlp2": m2a + m2b}


def shard_renders(shards: Path, cube_shards: Path, ckpt) -> dict:
    """``render --shards``: 2 eval frames of shard scenes at 512x1024
    under the serving preset at 4096-ray chunks, the references at their
    stored depth, from the shard-trained checkpoint: 160 mlp2 launches a
    frame, finite metrics in range; ``render_cubes --shards``: the first
    cube-shard scene's six 256x256 faces against the stored faces, the
    stored face poses as cameras, 192 launches.  All ``lanes``; no mlp3."""
    common = ["--height", str(H), "--width", str(W), "--depth-height",
              str(DH), "--depth-width", str(DW), "--ckpt", str(ckpt),
              "--device", "cuda"]
    per_frame = H * W // 4096 + (H // 2) * (W // 2) // 4096
    runs = {"render_shards": (render_tool, [
                "--shards", str(shards), "--num", "2", "--preset",
                "serving", "--chunk", "4096", "--no-skip", "--out",
                str(DATA_RUNS / "render")], 2 * per_frame),
            "render_cubes_shards": (render_cubes, [
                "--shards", str(cube_shards), "--num", "1", "--out",
                str(DATA_RUNS / "render_cubes")],
                6 * -(-(H // 2) ** 2 // render_cubes.CHUNK) * 2)}
    counts = {}
    for phase, (tool, argv, expected) in runs.items():
        fused_mlp.reset_launches()
        t0 = time.perf_counter()
        summary = tool.main(common + argv)
        seconds = time.perf_counter() - t0
        count, count3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
        variants = dict(fused_mlp.VARIANT_LAUNCHES)
        scored = summary["frames"] if "frames" in summary \
            else summary["faces"]
        row = {"phase": phase, "hw": [H, W], "mlp2_launches": count,
               "mlp3_launches": count3, "variant_launches": variants,
               "cli_seconds": seconds, "mean": summary["mean"],
               "scored": len(scored)}
        if "sec_per_face" in summary:
            row["sec_per_face"] = summary["sec_per_face"]
        else:
            row["sec_per_frame"] = [f["sec_per_frame"] for f in scored]
        emit(row)
        ok = len(scored) == (2 if phase == "render_shards" else 6) and all(
            np.isfinite(m[k]) and 0 < m["psnr_nr"] < 100
            and -1 <= m["ssim_nr"] <= 1 for m in scored for k in m)
        if not ok:
            raise AssertionError(f"{phase}: {summary}")
        if count != expected or count3:
            raise AssertionError(f"{phase}: mlp2 launched {count} times, "
                                 f"expected {expected}; mlp3 {count3}")
        assert_specialised(phase, count, variants)
        counts[phase] = count
    return counts


def _silhouette_close(a: np.ndarray, b: np.ndarray, tol: float,
                      pixels: int = 4) -> int:
    """Pixels of (..., C) images further apart than ``tol``, asserted at
    most ``pixels`` (silhouette pixels may flip between a sphere and the
    room under float rounding of the ray-sphere test)."""
    bad = int((np.abs(a - b).max(-1) > tol).sum())
    if bad > pixels:
        raise AssertionError(f"{bad} pixels beyond {tol}")
    return bad


def data_cuda_vs_cpu() -> None:
    """At 64x128: the online generator's cube sample rendered on the card
    against the CPU (rgb within 1e-5 and depth within 1e-4 but for at
    most 4 silhouette pixels per key, poses within 1e-7 / 1e-6), and the
    readers' antialiased resize (shrink and enlarge) and the
    augmentations' arithmetic (yaw roll, photometric jitter at fixed
    draws) on the same input on the card and the CPU, within 1e-6."""
    h, w = 64, 128
    got = {d: OnlineImageGenerator("val", h, w, with_cubes=True, seed=3,
                                   device=d)[0] for d in ("cuda", "cpu")}
    pix = {k: _silhouette_close(got["cuda"][k], got["cpu"][k], tol)
           for k, tol in (("rgb_panos", 1e-5), ("depth_panos", 1e-4),
                          ("rgb_cubes", 1e-5), ("depth_cubes", 1e-4))}
    pose = {k: float(np.abs(got["cuda"][k] - got["cpu"][k]).max())
            for k in ("rots", "trans", "rots_cubes", "trans_cubes")}
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(3, h, w, 3)).astype(np.float32)
    resize = {}
    for hw in ((32, 64), (40, 128), (128, 256)):
        out = {d: readers.resize_bilinear(torch.tensor(img, device=d), hw)
               .cpu() for d in ("cuda", "cpu")}
        resize[str(hw)] = (out["cuda"] - out["cpu"]).abs().max().item()
    sample = {"rgb_panos": img, "depth_panos": rng.uniform(
        0.5, 8.0, size=(3, h, w, 1)).astype(np.float32),
        "rots": got["cpu"]["rots"], "trans": got["cpu"]["trans"]}
    aug = {}
    for d in ("cuda", "cpu"):
        s = augment.yaw_roll(shards_mod.sample_to_torch(sample, d), 37)
        aug[d] = augment.photometric_jitter(s, 1.13, 0.91,
                                            [0.95, 1.04, 1.08])
    aug_err = {k: (aug["cuda"][k].cpu() - aug["cpu"][k]).abs().max().item()
               for k in ("rgb_panos", "depth_panos", "rots")}
    emit({"phase": "data_cuda_vs_cpu", "hw": [h, w],
          "pixels_beyond_tol": pix, "max_abs_err_pose": pose,
          "max_abs_err_resize": resize, "max_abs_err_augment": aug_err})
    if pose["rots"] > 1e-7 or pose["rots_cubes"] > 1e-7 or \
            pose["trans"] > 1e-6 or pose["trans_cubes"] > 1e-6 or \
            max(resize.values()) > 1e-6 or max(aug_err.values()) > 1e-6:
        raise AssertionError(f"data_cuda_vs_cpu: pose {pose}, resize "
                             f"{resize}, augment {aug_err}")


def data_pipeline(pool_ms) -> dict:
    """The data group: shards written on the card (8 three-view samples at
    512x1024, 256 more in 4 shards of 64 (3.2 GB), 4 at 256x512 for the
    MVS recipe, 4 validation cube samples at 512x1024), the LMDB import,
    the reader's host cost and the renderer's and mono trainers on the
    256 samples, the MVS trainer and the two render CLIs on the small
    directories, and the CUDA-against-CPU checks.  Returns the mlp2 launches of the shard paths and the mlp3
    launches of the training runs."""
    DATA_RUNS.mkdir(parents=True, exist_ok=True)
    shards, big, mvs_shards, cube_shards = (DATA_RUNS / n for n in (
        "shards_512", "shards_512_4x64", "shards_256", "cubes_val"))
    prepare_shards("prepare_shards", shards,
                   ["--height", str(H), "--width", str(W)], 8)
    prepare_shards("prepare_shards_64", big,
                   ["--height", str(H), "--width", str(W), "--seed", "2"],
                   256)
    prepare_shards("prepare_shards_mvs", mvs_shards,
                   ["--height", str(H // 2), "--width", str(W // 2),
                    "--m3d-dist", "1.0", "--seed", "1"], 4)
    prepare_shards("prepare_shards_cubes", cube_shards,
                   ["--height", str(H), "--width", str(W), "--cubes",
                    "--split", "val"], 4)
    lmdb_import_check(cube_shards)
    reader_timing(big)
    trained = shard_training(big, mvs_shards, pool_ms)
    shutil.rmtree(big)
    renders = shard_renders(shards, cube_shards, trained["ckpt"])
    data_cuda_vs_cpu()
    return {"train_per_step": trained["per_step"],
            "render": renders["render_shards"],
            "render_cubes": renders["render_cubes_shards"],
            "mlp3": trained["mlp3"]}


# ---------------------------------------------------------------------------
# multi-GPU: --mesh 1 (NCCL) through the CLIs, 2 ranks on the card (gloo)
# ---------------------------------------------------------------------------

MESH_STEPS = 3           # 1 warm-up + 2 timed
MESH_RUNS = Path("data/chip_smoke_mesh")


def timed_cli(tool, argv: list) -> tuple:
    """``tool.run_rank`` in process (its run without a mesh, or with
    ``--mesh 1`` through ``main``: a world of one NCCL rank), each step's
    end timed with a CUDA event and its kernel launches counted.  Returns
    (run_rank's result: losses, first-step gradients, checkpoint; the
    steps; the ms between step ends; the seconds of the whole run)."""
    steps = []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps.append({"loss": metrics["loss"], "ev": ev,
                      "mlp2": fused_mlp.MLP2_LAUNCHES,
                      "lanes": fused_mlp.VARIANT_LAUNCHES["mlp2_lanes"],
                      "mlp3": fused_mlp.MLP3_LAUNCHES})
        fused_mlp.reset_launches()

    fused_mlp.reset_launches()
    t0 = time.perf_counter()
    if "--mesh" in argv:
        result = tool.main(argv, log_fn=on_step)
    else:
        result = tool.run_rank(tool.parse_args(argv), log_fn=on_step)
    seconds = time.perf_counter() - t0
    ms = [a["ev"].elapsed_time(b["ev"]) for a, b in zip(steps, steps[1:])]
    return result, steps, ms, seconds


def _launch_check(phase: str, runs: dict, per_step: int) -> None:
    """Each run's mlp2 launches: ``per_step`` a step (a frame), all
    ``lanes``; mlp3 none."""
    for run, r in runs.items():
        want = [per_step] * len(r["mlp2"])
        if r["mlp2"] != want or r["lanes"] != r["mlp2"] or any(r["mlp3"]):
            raise AssertionError(f"{phase} {run}: mlp2 {r['mlp2']} (want "
                                 f"{want}), lanes {r['lanes']}, mlp3 "
                                 f"{r['mlp3']}")


def _cli_runs(phase: str, tool, argv: list, grad_rtol: float,
              per_step: int, name=None) -> dict:
    """``tool`` without ``--mesh`` and with ``--mesh 1`` (NCCL), each fresh
    under its own ``name`` when one is given: the same first losses
    (1e-4), the first step's clipped gradients within ``_grad_gap``'s
    ``grad_rtol``, ``per_step`` mlp2 launches a step, all ``lanes``, no
    mlp3.  Emits the phase's line."""
    runs, grads = {}, {}
    for run, extra in (("one", []), ("mesh1", ["--mesh", "1"])):
        named = [] if name is None else ["--name", f"{name}_{run}"]
        if name is not None:
            shutil.rmtree(f"{DEPTH_RUNS}/{name}_{run}", ignore_errors=True)
        result, steps, ms, seconds = timed_cli(tool, argv + named + extra)
        grads[run] = result["grads"]
        runs[run] = {
            "losses": [s["loss"] for s in steps],
            "ms_per_step": statistics.median(ms), "ms_runs": ms,
            "cli_seconds": seconds,
            "mlp2": [s["mlp2"] for s in steps],
            "lanes": [s["lanes"] for s in steps],
            "mlp3": [s["mlp3"] for s in steps]}
    gap = _grad_gap(grads["mesh1"], grads["one"], grad_rtol)
    emit({"phase": phase, "argv": argv, "steps": MESH_STEPS,
          "card": gpu_name_and_power(), **runs,
          "first_step_grad_gap": gap, "grad_rtol": grad_rtol})
    one, mesh = runs.values()
    if len(mesh["losses"]) != MESH_STEPS or not all(
            np.isfinite(mesh["losses"])) or not np.isclose(
            mesh["losses"][0], one["losses"][0], rtol=1e-4) \
            or gap[0] > 1.0:
        raise AssertionError(f"{phase}: losses {one['losses']} / "
                             f"{mesh['losses']}, gradient gap {gap}")
    _launch_check(phase, runs, per_step)
    return runs


def read_frame(png: Path) -> np.ndarray:
    """A frame the render CLI wrote: its PNG, or the ``.npy`` it writes
    without imageio."""
    if png.exists():
        from PIL import Image
        return np.asarray(Image.open(png))
    return np.load(png.with_suffix(".npy"))


def _mesh_render_cli() -> None:
    """The render CLI's eval frame (512x1024, serving, 4096-ray chunks,
    the scene's depth) without ``--mesh`` and with ``--mesh 1`` (NCCL,
    ``render_image_sharded``): the same metrics and frame to one uint8
    level, 160 mlp2 launches in process, all ``lanes``."""
    chunk = 4096
    per_frame = H * W // chunk + (H // 2) * (W // 2) // chunk
    runs, frames = {}, {}
    for run, extra in (("one", []), ("mesh1", ["--mesh", "1"])):
        out = MESH_RUNS / f"render_{run}"
        fused_mlp.reset_launches()
        t0 = time.perf_counter()
        summary = render_tool.main([
            "--height", str(H), "--width", str(W), "--depth-height",
            str(DH), "--depth-width", str(DW), "--preset", "serving",
            "--chunk", str(chunk), "--num", "1", "--no-skip", "--out",
            str(out), "--device", "cuda", *extra])
        runs[run] = {"cli_seconds": time.perf_counter() - t0,
                     **summary["mean"],
                     "mlp2": [fused_mlp.MLP2_LAUNCHES],
                     "lanes": [fused_mlp.VARIANT_LAUNCHES["mlp2_lanes"]],
                     "mlp3": [fused_mlp.MLP3_LAUNCHES]}
        frames[run] = read_frame(out / "0-nr_fine.png")
    one, other = frames.values()
    diff = int(np.abs(one.astype(np.int16) - other).max())
    emit({"phase": "mesh_render", "hw": [H, W], "chunk": chunk,
          "card": gpu_name_and_power(), **runs, "max_uint8_diff": diff})
    _launch_check("mesh_render", runs, per_frame)
    psnr = [r["psnr_nr"] for r in runs.values()]
    if diff > 1 or not np.isclose(*psnr, rtol=1e-4):
        raise AssertionError(f"mesh_render: frames differ ({diff}) {runs}")


def _grad_gap(a: dict, b: dict, rtol: float) -> tuple:
    """(the worst ratio of ``a``'s gradient errors against ``b``'s to their
    allowance, its tensor): ``rtol`` of each tensor's largest plus 1e-5 of
    the largest of all (a conv bias in front of an instance norm has a
    gradient that is 0 but for rounding noise); 1 or less passes."""
    top = max(float(np.abs(v).max()) for v in b.values())
    return max((float(np.abs(a[k] - v).max())
                / (rtol * float(np.abs(v).max()) + 1e-5 * top), k)
               for k, v in b.items())


def _mono_job(h: int, w: int, batch: int, dtype, steps: int) -> tuple:
    """``programs.depth_steps`` of the mono recipe's UniFuse (seeded) on a
    random batch at h x w in ``dtype``."""
    mono = tunifuse.select_mono({"mono_net": "UniFuse", "max_depth": 10.0,
                                 "mono_uncertainty": False,
                                 "mono_num_layers": 18, "nrows": 4,
                                 "patchsize": 64})
    tblocks.init_parameters_(mono, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    equi = tunifuse.normalize_imagenet(torch.tensor(
        rng.uniform(size=(batch, h, w, 3)), dtype=dtype))
    depth_batch = {"equi": equi.numpy(),
                   "cube": cubemap.equi_to_cube(equi, h // 2).numpy(),
                   "gt_depth": rng.uniform(0.5, 9.0, (batch, h, w, 1))
                   .astype(equi.numpy().dtype)}
    return (programs.depth_steps, dict(
        model=mono.to(dtype), batch=depth_batch, inputs=("equi", "cube"),
        cfg=depth_trainer.DepthTrainConfig(aux_d1_weight=0.0),
        device="cuda", steps=steps))


def mesh_programs(ranks: int, backend: str) -> dict:
    """The sharded depth step (the mono recipe's UniFuse at 512x1024, batch
    max(2, ranks) split over the ranks, cross-rank BatchNorm), the sharded
    renderer step (the 2-view recipe's model and batch, 512 rays split)
    and the sharded serving frame (bench.py's inputs, 4096-ray chunks,
    coarse pass at (H/2, W/2)) on ``ranks`` ranks over ``backend`` (gloo:
    all on the one card), against the same programs on 1 rank: first
    losses within 1e-4, the renderer's first-step gradients within
    ``_grad_gap``'s 1e-3, the frame within 2e-3; mlp2 launches per rank
    2 a step and 160 / ``ranks`` a frame, all ``lanes``; mlp3 none.  The
    depth net's float32 gradients are ill-conditioned (its stacked
    training BatchNorms move them by several 1e-2 of a tensor's largest
    with the order of the sums), so one more step in float64 at 256x512
    holds them to 1e-6.  Returns the launches per rank."""
    batch_size = max(2, ranks)
    trainer, stream, _ = train_renderer.build(train_renderer.parse_args(
        ["--cfg", TRAIN_CFG, "--pool", "1", "--device", "cpu"]))
    batch = {k: {kk: vv.numpy() for kk, vv in v.items()}
             if isinstance(v, dict) else v.numpy()
             for k, v in next(stream).items()}
    serving = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW), **preset_kwargs("serving"),
        device="cpu", generator=torch.Generator().manual_seed(0))
    ref_info, c2w, qdr = bench.bench_inputs(H, W, DH, DW)
    chunk = 4096
    jobs = [_mono_job(H, W, batch_size, torch.float32, MESH_STEPS),
            (programs.renderer_steps, dict(
                model=trainer.model, batch=batch, cfg=trainer.cfg,
                device="cuda", steps=MESH_STEPS)),
            (programs.render_frame, dict(
                model=serving, ref_info=ref_info, que_c2w=c2w,
                que_depth_range=qdr, device="cuda", coarse_lowres=2,
                chunk=chunk, repeat=2)),
            _mono_job(H // 2, W // 2, batch_size, torch.float64, 1)]
    worlds, seconds = {}, {}
    for n in (1, ranks):
        t0 = time.perf_counter()
        worlds[n] = run_ranks(programs.run_all, n, "cuda", (jobs,),
                              backend=backend, deadline_s=900)
        seconds[n] = time.perf_counter() - t0
    (d1, r1, f1, e1), (dn, rn, fn, en) = worlds[1], worlds[ranks]
    rows = {
        "mesh_depth_step": {
            "what": f"UniFuse 512x1024, batch {batch_size}, train_mono's "
                    f"recipe",
            "losses": {1: d1["losses"], ranks: dn["losses"]},
            "grad_gap_float32": _grad_gap(dn["grads"], d1["grads"], 1e-2),
            "float64_256x512": {
                "losses": {1: e1["losses"], ranks: en["losses"]},
                "grad_gap": _grad_gap(en["grads"], e1["grads"], 1e-6)},
            "ms_per_step": {1: statistics.median(d1["ms"]),
                            ranks: statistics.median(dn["ms"])},
            "ms_runs": {1: d1["ms"], ranks: dn["ms"]},
            "launches": {1: d1["launches"], ranks: dn["launches"]}},
        "mesh_renderer_step": {
            "what": f"{TRAIN_CFG}, 512 rays",
            "losses": {1: [float(m["loss"]) for m in r1["metrics"]],
                       ranks: [float(m["loss"]) for m in rn["metrics"]]},
            "grad_gap": _grad_gap(rn["grads"], r1["grads"], 1e-3),
            "ms_per_step": {1: statistics.median(r1["ms"]),
                            ranks: statistics.median(rn["ms"])},
            "ms_runs": {1: r1["ms"], ranks: rn["ms"]},
            "launches": {1: r1["launches"], ranks: rn["launches"]}},
        "mesh_frame": {
            "what": "serving 512x1024, 4096-ray chunks, coarse at H/2",
            "max_abs_diff": float(np.abs(fn["rgb"] - f1["rgb"]).max()),
            "ms_per_frame": {1: statistics.median(f1["ms"]),
                             ranks: statistics.median(fn["ms"])},
            "ms_runs": {1: f1["ms"], ranks: fn["ms"]},
            "launches": {1: f1["launches"], ranks: fn["launches"]}}}
    card = gpu_name_and_power()
    for phase, row in rows.items():
        emit({"phase": phase, "backend": backend, "ranks": ranks,
              "card": card, "group_seconds": seconds, **row})
    dl, rl, fl = (rows[k]["launches"] for k in rows)
    per_frame = H * W // chunk + (H // 2) * (W // 2) // chunk
    checks = {
        "depth_loss": bool(np.isclose(dn["losses"][0], d1["losses"][0],
                                      rtol=1e-4)),
        "depth_float64": bool(np.isclose(en["losses"][0], e1["losses"][0],
                                         rtol=1e-9)) and
        rows["mesh_depth_step"]["float64_256x512"]["grad_gap"][0] <= 1.0,
        "renderer_loss": bool(np.isclose(rn["metrics"][0]["loss"],
                                         r1["metrics"][0]["loss"],
                                         rtol=1e-4)),
        "renderer_grads": rows["mesh_renderer_step"]["grad_gap"][0] <= 1.0,
        "frame": rows["mesh_frame"]["max_abs_diff"] <= 2e-3,
        "depth_launches": dl[1]["mlp2"] == [0] and
        dl[ranks]["mlp2"] == [0] * ranks,
        "train_launches": rl[1]["mlp2"] == [2 * MESH_STEPS] and
        rl[ranks]["mlp2"] == [2 * MESH_STEPS] * ranks,
        "frame_launches": fl[1]["mlp2"] == [per_frame] and
        fl[ranks]["mlp2"] == [per_frame // ranks] * ranks,
        "lanes_no_mlp3": all(w["mlp2_lanes"] == w["mlp2"] and
                             not any(w["mlp3"])
                             for x in (dl, rl, fl) for w in x.values())}
    if not all(checks.values()):
        raise AssertionError(f"mesh programs: checks {checks}")
    return {"frame_per_rank": fl[ranks]["mlp2"],
            "train_per_rank_per_step": [c // MESH_STEPS
                                        for c in rl[ranks]["mlp2"]]}


def parallel_group() -> dict:
    """The ``parallel`` group: ``--mesh 1`` (NCCL) through ``train_mono``,
    ``train_depth``, ``train_renderer`` and ``render`` against the same
    CLIs without it, then ``mesh_programs`` on 2 gloo ranks sharing the
    card.  Returns the mlp2 launches per rank of the sharded frame and
    step."""
    MESH_RUNS.mkdir(parents=True, exist_ok=True)
    # float32 BatchNorm: the world-1 synced statistics (mean(x^2) -
    # mean(x)^2) round otherwise than cuDNN's, and the stacked training
    # BatchNorms move the gradients by some 1e-2 of a tensor's largest
    # (measured on an H100: mono 5.8e-2 in the deepest encoder layer, MVS
    # 1.3e-2); a gradient of the wrong sign or none is off by its size
    _cli_runs("mesh_train_mono", train_mono, [
        "--height", str(H), "--width", str(W), "--batch", "2", "--steps",
        str(MESH_STEPS), "--log-interval", "1", "--vis-interval", "0",
        "--device", "cuda"], 2e-1, 0, "chip_smoke_mesh_train_mono")
    _cli_runs("mesh_train_depth", train_depth, [
        "--cfg", MVS_CFG, "--batch", "2", "--steps", str(MESH_STEPS),
        "--log-interval", "1", "--vis-interval", "0", "--device", "cuda"],
        2e-1, 0, "chip_smoke_mesh_train_depth")
    # the renderer has no training BatchNorm: one rank's step is the plain
    # step's arithmetic
    _cli_runs("mesh_train", train_renderer, [
        "--cfg", TRAIN_CFG, "--pool", "2", "--steps", str(MESH_STEPS),
        "--log-interval", "1", "--device", "cuda"], 1e-3, 2)
    _mesh_render_cli()
    return mesh_programs(2, "gloo")

# ---------------------------------------------------------------------------
# measurement and evaluation tools
# ---------------------------------------------------------------------------

MEASURE_OUT = Path("data/chip_smoke_measure")
BENCH_CHUNK = 4096
# tools.bench runs: (argv, mlp2 launches a frame); one mlp2 launch per
# chunk pass: 128 fine + 32 coarse (H/2 x W/2) chunks at 4096 rays, none
# when the aggregation (where out_geometry_fc lives) is ablated, one pass
# of 128 chunks for DINER
BENCH_RUNS = {
    "chunk4096": (["--chunk", str(BENCH_CHUNK)], 160),
    "video_b2": (["--chunk", str(BENCH_CHUNK), "--video-batch", "2",
                  "--no-roofline"], 160),
    "depth_stack": (["--chunk", str(BENCH_CHUNK), "--with-depth-stack",
                     "--no-roofline"], 160),
    "ablate_agg": (["--chunk", str(BENCH_CHUNK), "--ablate", "agg"], 0),
    "ablate_gather": (["--chunk", str(BENCH_CHUNK), "--ablate", "gather"],
                      160),
    "ablate_attn": (["--chunk", str(BENCH_CHUNK), "--ablate", "attn"], 160),
    "diner": (["--chunk", str(BENCH_CHUNK), "--diner"], 128),
    # the tool's default: serving at 256-ray chunks (2048 fine + 512
    # coarse launches) and the turbo point
    "default": ([], H * W // 256 + (H // 2) * (W // 2) // 256),
}


def bench_tool(card: str) -> dict:
    """``tools.bench`` at 512x1024 in each mode of BENCH_RUNS, in process:
    its JSON line (with the card), the mlp2 launches of its counted frame
    (and of a B = 2 video pass) asserted, all ``lanes``, no mlp3; the
    whole call's launches, finite positive times, and on the roofline run
    an agg MFU in (0, 1.05].  Returns {run: mlp2 launches a frame}."""
    launches = {}
    for run, (argv, expected) in BENCH_RUNS.items():
        fused_mlp.reset_launches()
        t0 = time.perf_counter()
        rec = bench.main(argv)
        seconds = time.perf_counter() - t0
        calls = fused_mlp.MLP2_LAUNCHES
        emit({"phase": "bench", "run": run, "argv": argv, **rec,
              "tool_seconds": seconds, "mlp2_launches_in_call": calls,
              "card": card})
        counts = [(rec["mlp2_launches"], rec["mlp2_lanes_launches"])]
        if "video_batch" in rec:
            counts.append((rec["video_mlp2_launches"],
                           rec["video_mlp2_lanes_launches"]))
        if any(c != (expected, expected) for c in counts) or \
                rec["mlp3_launches"] or (expected and not calls):
            raise AssertionError(f"bench {run}: mlp2 (all, lanes) {counts},"
                                 f" expected {expected}; mlp3 "
                                 f"{rec['mlp3_launches']}")
        times = [rec["value"], *rec["runs"]] + [
            rec[k] for k in ("turbo_ms_per_frame", "video_ms_per_frame",
                             "scene_prep_ms", "agg_ms", "gather_ms",
                             "gather_ns_per_row")
            if k in rec]
        if not all(np.isfinite(t) and t > 0 for t in times) or \
                rec["vs_baseline"] is not None:
            raise AssertionError(f"bench {run}: {rec}")
        if "agg_mfu" in rec and not 0 < rec["agg_mfu"] <= 1.05:
            raise AssertionError(f"bench {run}: agg MFU {rec['agg_mfu']}")
        launches[run] = rec["mlp2_launches"]
    return launches


def gather_row_sweep(card: str) -> None:
    """ns per merged-map row: the bilinear fetch of one chunk's strided
    serving rows (``tools.bench.frame_rows``: coarse stride 4 at (H/2,
    W/2), fine 16) iterated on the card by ``tools.bench.time_chain``, in
    the depth-major order the frame fetches and in a random order, at the
    serving chunk (256 rays) and at 4096 rays; 4 rows (a 2x2 window) per
    point and view.  The time per row falls with the chunk, so the
    roofline keeps no per-row constant (``GATHER_NS_PER_ROW`` None) and
    ``tools.bench`` reports its own chunk's."""
    ref_info, c2w, _ = bench.bench_inputs(H, W, DH, DW)
    w2c = torch.as_tensor(ref_info["w2c"], dtype=torch.float32,
                          device="cuda")
    g = torch.Generator("cuda").manual_seed(0)
    merged = torch.rand(RFN, H, W, 77, device="cuda", generator=g).to(BF16)
    step = bench.gather_step(merged)
    row = {"phase": "gather_rows", "row_channels": 77, "dtype": "bfloat16",
           "card": card}
    with torch.inference_mode():
        for chunk in (PRESET_CHUNK["serving"], BENCH_CHUNK):
            pts = bench.frame_rows(H, W, chunk, 64, (4, 16), 2, c2w, w2c)
            perm = torch.randperm(pts.shape[1], device="cuda", generator=g)
            for order, p in (("depth_major", pts), ("scattered",
                                                    pts[:, perm])):
                s = bench.time_chain(step, p, 256, torch.device("cuda"))
                rows = p.shape[0] * p.shape[1] * 4
                row[f"ns_per_row_{order}_{chunk}"] = s * 1e9 / rows
                row[f"us_per_call_{order}_{chunk}"] = s * 1e6
            row[f"rows_per_call_{chunk}"] = rows
    emit(row)
    if not all(v > 0 for k, v in row.items() if k.startswith("ns_")):
        raise AssertionError(f"gather_rows: {row}")


def bench_train_tool(card: str) -> dict:
    """``tools.bench_train`` on both recipes at full width (5 timed steps
    after a warm-up): ms/step, finite losses, 2 mlp2 launches a step of
    the gen recipe (both ``lanes``) and none in the MVS recipe."""
    rows = bench_train.main(["--recipe", "all", "--iters",
                             str(TRAIN_STEPS - 1)])
    out = {}
    for rec, per_step in zip(rows, (2, 0)):
        emit({"phase": "bench_train", **rec, "card": card})
        want = [per_step] * TRAIN_STEPS
        if rec["mlp2_launches_per_step"] != want or \
                rec["mlp2_lanes_launches_per_step"] != want or \
                not np.isfinite(rec["losses"]).all() or rec["value"] <= 0:
            raise AssertionError(f"bench_train: {rec}")
        out[rec["metric"]] = rec["mlp2_launches_per_step"][-1]
    return out


def lpips_check(card: str) -> Path:
    """LPIPS (``train/lpips.py``, random weights from seed 0) on two
    512x1024 images on the card (ms, median of 3), then at 64x128 on the
    card against the CPU (relative 1e-4).  Returns the weights, saved as
    the JAX package's ``.npz``."""
    rng = np.random.default_rng(5)
    model = tlpips.LPIPS(torch.Generator().manual_seed(0))
    path = MEASURE_OUT / "lpips_random.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    tlpips.save_lpips_weights(model, path)
    cuda = tlpips.lpips_fn(tlpips.load_lpips_weights(path, "cuda"))
    cpu = tlpips.lpips_fn(tlpips.load_lpips_weights(path, "cpu"))

    def pair(h, w):
        a = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
        b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1)
        return torch.tensor(a), torch.tensor(b, dtype=torch.float32)
    a, b = (t.cuda() for t in pair(H, W))
    full = cuda(a, b)
    ms, runs = timed_ms(lambda: cuda(a, b))
    a, b = pair(64, 128)
    small_cuda, small_cpu = cuda(a.cuda(), b.cuda()).cpu(), cpu(a, b)
    rel = ((small_cuda - small_cpu).abs() / small_cpu.abs()).max().item()
    emit({"phase": "lpips", "hw": [H, W], "ms": ms, "ms_runs": runs,
          "lpips": full.item(), "hw_small": [64, 128],
          "lpips_small_cuda": small_cuda.item(),
          "lpips_small_cpu": small_cpu.item(), "rel_cuda_vs_cpu": rel,
          "card": card})
    if not (torch.isfinite(full).all() and full.item() > 0) or \
            not rel <= 1e-4:
        raise AssertionError(f"lpips: {full}, cuda vs cpu {rel}")
    return path


def trainer_files() -> dict:
    """Seeded renderer, mono and MVS files written by the trainers' own
    ``save`` (for ``parity_check`` when the training groups do not run)."""
    root = MEASURE_OUT / "ckpts"
    g = torch.Generator().manual_seed(0)
    renderer = NeuralRayGenRenderer(height=H, width=W, depth_hw=(DH, DW),
                                    device="cpu", generator=g)
    gen = trainer_mod.Trainer(renderer, None, trainer_mod.TrainerConfig(
        name="gen", save_dir=str(root))).save("latest")
    mono = tunifuse.UniFuse()
    tblocks.init_parameters_(mono, g)
    mono_ckpt = depth_trainer.DepthTrainer(
        mono, None, depth_trainer.DepthTrainConfig(
            name="mono", save_dir=str(root))).save()
    mvs = tmvs.MVSDepthModel()
    tblocks.init_parameters_(mvs, g)
    mvs_ckpt = depth_trainer.DepthTrainer(
        mvs, None, depth_trainer.DepthTrainConfig(
            name="mvs", save_dir=str(root)), frozen={"d_net": mono}).save()
    return {"renderer": gen, "mono": mono_ckpt, "mvs": mvs_ckpt}


def parity_check_tool(files: dict, lpips_weights: Path, card: str) -> int:
    """``tools.parity_check`` on the renderer, mono and MVS files of the
    training groups: every key loads, then the composed exact render of
    one 512x1024 scene (float32, 8192-ray chunks: 64 coarse + 64 fine
    mlp2 launches, all ``lanes``) with LPIPS, exit 0; the same renderer
    file with one tensor cut exits 1.  Returns the render's launches."""
    out = MEASURE_OUT / "parity"
    argv = ["--renderer-pth", str(files["renderer"]), "--mono-pth",
            str(files["mono"]), "--mvs-pth", str(files["mvs"]), "--num", "1",
            "--lpips-weights", str(lpips_weights), "--out", str(out)]
    fused_mlp.reset_launches()
    t0 = time.perf_counter()
    code = parity_check.main(argv)
    seconds = time.perf_counter() - t0
    count, count3 = fused_mlp.MLP2_LAUNCHES, fused_mlp.MLP3_LAUNCHES
    variants = dict(fused_mlp.VARIANT_LAUNCHES)
    mean = json.loads((out / "metric.txt").read_text())
    raw = torch.load(files["renderer"], weights_only=False)
    key = "agg_net.agg_impl.out_geometry_fc.0.weight"
    raw["network_state_dict"][key] = raw["network_state_dict"][key][:, :8]
    bad = MEASURE_OUT / "misshaped.pth"
    torch.save(raw, bad)
    bad_code = parity_check.main(["--renderer-pth", str(bad),
                                  "--key-check-only"])
    emit({"phase": "parity_check", "files": {k: str(v) for k, v in
                                             files.items()},
          "exit": code, "exit_misshaped": bad_code, "seconds": seconds,
          **mean, "mlp2_launches": count, "mlp3_launches": count3,
          "variant_launches": variants, "card": card})
    expected = 2 * H * W // 8192
    if code != 0 or bad_code != 1 or not all(
            np.isfinite(v) for v in mean.values()):
        raise AssertionError(f"parity_check: exit {code} / {bad_code}, "
                             f"{mean}")
    if count != expected or count3:
        raise AssertionError(f"parity_check: mlp2 launched {count} times, "
                             f"expected {expected}; mlp3 {count3}")
    assert_specialised("parity_check", count, variants)
    return count


def eval_dirs_tool(card: str) -> None:
    """``tools.eval_dirs`` over the render CLI's eval frame (the
    ``render_cli`` group's, else parity_check's): its PSNR, SSIM and
    WS-PSNR from the 8-bit images against the CLI's own metrics of the
    float frame (0.05 dB, 1e-2).  Without imageio the CLI writes its
    images as ``.npy`` (as the JAX tool does); they are written as PNG
    beside the tool's input first."""
    from PIL import Image
    src = Path(RENDER_OUT)
    if not (src / "metric.txt").exists():
        src = MEASURE_OUT / "parity"
    cli = json.loads((src / "metric.txt").read_text())
    frames = MEASURE_OUT / "eval_frames"
    frames.mkdir(parents=True, exist_ok=True)
    for name in ("0-nr_fine", "0-gt"):
        Image.fromarray(read_frame(src / f"{name}.png")).save(
            frames / f"{name}.png")
    mean = eval_dirs.main(["--dir_gt", str(frames), "--dir_pr",
                           str(frames)])
    emit({"phase": "eval_dirs", "dir": str(src), "images": str(frames),
          **(mean or {}), "cli_metrics": cli, "card": card})
    if mean is None or abs(mean["psnr_nr"] - cli["psnr_nr"]) > 0.05 or \
            abs(mean["wspsnr_nr"] - cli["wspsnr_nr"]) > 0.05 or \
            abs(mean["ssim_nr"] - cli["ssim_nr"]) > 1e-2:
        raise AssertionError(f"eval_dirs: {mean} against the CLI's {cli}")


def measure_group(files: dict) -> dict:
    """The measurement and evaluation tools on the card (see the phases'
    docstrings); ``files``: the training groups' renderer / mono / MVS
    files, None to write seeded ones.  Returns mlp2 launches by path."""
    card = gpu_name_and_power()
    out = {f"bench_{k}": v for k, v in bench_tool(card).items()}
    gather_row_sweep(card)
    out.update(bench_train_tool(card))
    weights = lpips_check(card)
    out["parity_check"] = parity_check_tool(files or trainer_files(),
                                            weights, card)
    eval_dirs_tool(card)
    return out


PHASES = ("kernels", "serving", "training", "depth_stack",
          "depth_training", "render_cli", "video", "mv_ft", "modes",
          "depth_variants", "data", "parallel", "measure")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                             "one NVIDIA GPU")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of the groups to run, of "
                         f"{', '.join(PHASES)} (default: all; the result "
                         "lines need all)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = gpu_name_and_power()
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    build()
    row, row3 = {}, {"launches": 0}
    if "kernels" in phases:
        row = check_and_time("mlp2")
        row3 = check_and_time("mlp3")
        row3["launches"] = 0
        grad_check()
    if "serving" in phases:
        launches, mlp3_serving = render_full_width()
        row["launches"] = launches["serving"]
        row["launches_turbo"] = launches["turbo"]
        row3["launches"] += mlp3_serving
        cuda_vs_cpu()
    gen_ckpt = mono_ckpt = mvs_ckpt = pool_ms = None
    if "training" in phases:
        row["launches_train_per_step"], mlp3_train, gen_ckpt, pool_ms = \
            train_full_width()
        row3["launches"] += mlp3_train
        train_cuda_vs_cpu()
    if "depth_stack" in phases:
        depth_stack_full_width()
        depth_stack_cuda_vs_cpu()
    if "depth_training" in phases:
        runs = depth_train_full_width()
        row["launches_depth_train_mono"] = runs["mlp2"]["mono"]
        row["launches_depth_train_mvs"] = runs["mlp2"]["mvs"]
        row3["launches"] += runs["mlp3"]
        depth_train_cuda_vs_cpu()
        depth_eval(runs["mono_ckpt"], runs["mvs_ckpt"])
        mono_ckpt, mvs_ckpt = runs["mono_ckpt"], runs["mvs_ckpt"]
    if "render_cli" in phases:
        cli = render_cli(mvs_ckpt or random_mvs_ckpt())
        row["launches_render_cli_eval"] = cli["eval"]
        row["launches_render_cli_path_b2"] = cli["inter_b2"]
        row["launches_render_cli_path_b1"] = cli["inter_b1"]
    if "video" in phases:
        video_cuda()
    if "mv_ft" in phases:
        mv, mlp3_mv, mv_ckpt = train_mv()
        row["launches_train_mv_per_step"] = mv["train_mv"]
        row["launches_train_consistency_per_step"] = mv["train_consistency"]
        row["launches_train_ft_per_step"], mlp3_ft, ft_ckpt = \
            train_ft_full_width(gen_ckpt)
        ft_renders, mlp3_rft = render_ft_cli(ft_ckpt)
        row["launches_render_ft"] = ft_renders["eval"]
        row["launches_render_ft_path"] = ft_renders["inter"]
        mv_renders, mlp3_rmv = render_mv_cli(mv_ckpt)
        row["launches_render_mv"] = mv_renders["eval"]
        row3["launches"] += mlp3_mv + mlp3_ft + mlp3_rft + mlp3_rmv
        mv_ft_cuda_vs_cpu()
    if "modes" in phases:
        # each path below asserts its own mlp3 count of 0
        frames = mode_frames()
        row["launches_diner_frame"] = frames["diner"]
        row["launches_diner_mu64_frame"] = frames["diner_mu64"]
        row["launches_light_coarse_frame"] = frames["light_coarse"]
        row["launches_render_cubes"] = render_cubes_cli()
        ab = ab_quality_cli()
        row["launches_ab_quality_train_per_step"] = ab["train_per_step"]
        row["launches_ab_quality_diner"] = ab["diner"]
        row["launches_ab_quality_diner_mu64"] = ab["diner_mu64"]
        modes_cuda_vs_cpu()
    if "depth_variants" in phases:
        # each run below asserts its own mlp2 and mlp3 counts
        row["launches_depth_variants"] = variant_training()
        feature_net_forwards()
        row["launches_erp_tp_frame"] = erp_tp_frame()
        variant_cuda_vs_cpu()
        cube_encoder_float64_check()
    if "data" in phases:
        data = data_pipeline(pool_ms)
        row["launches_shards_train_per_step"] = data["train_per_step"]
        row["launches_shards_render"] = data["render"]
        row["launches_shards_render_cubes"] = data["render_cubes"]
        row3["launches"] += data["mlp3"]
    if "parallel" in phases:
        # each run asserts its own mlp3 count of 0
        par = parallel_group()
        row["launches_mesh_frame_per_rank"] = par["frame_per_rank"]
        row["launches_mesh_train_per_rank_per_step"] = \
            par["train_per_rank_per_step"]
    if "measure" in phases:
        # each run asserts its own mlp3 count of 0
        files = None if None in (gen_ckpt, mono_ckpt, mvs_ckpt) else {
            "renderer": gen_ckpt, "mono": mono_ckpt, "mvs": mvs_ckpt}
        for path, n in measure_group(files).items():
            row[f"launches_{path}"] = n
    # no path of either package calls mlp3: the main paths launch it 0 times
    # (render_cli asserts its own 0)
    if row3["launches"] != 0:
        raise AssertionError(f"mlp3 launched {row3['launches']} times on the "
                             f"main paths, which have no caller of it")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    if phases != set(PHASES):
        print("chip_smoke: a subset of the phases ran; no result",
              file=sys.stderr)
        return 2
    print(smi)
    emit({"kernels": [row, row3]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
