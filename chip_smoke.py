"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``panogrf_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card, renders 512x1024 frames of
the serving render at full width (``serving`` and ``turbo`` at their
256-ray chunk, then ``serving`` at 4096-ray chunks), checks that the path
went through the kernels, profiles fine-pass chunks of both sizes, and
checks the CUDA path against the CPU path at 64x128.  Each phase prints
one JSON line; any failure raises, so the process exits non-zero.  The
last three lines are the card's name and power limit, the kernel table
and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository, it fails before printing a result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from panogrf_tpu_torch.ops.kernels import _build, fused_mlp
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.presets import (PRESET_CHUNK,
                                                PRESET_COARSE_LOWRES,
                                                preset_kwargs)
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer

H, W, DH, DW, RFN = 512, 1024, 256, 512, 2
# H100 SXM data-sheet peaks (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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
    return [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]


def profiler_time_ms(fn, iters: int = 50) -> float:
    """Mean device time per call as torch.profiler sums it: the duration
    of the GPU kernels one call launches, without the gaps between them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r[1] for r in _cuda_kernel_rows(prof)) / iters / 1e3


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def mlp2_inputs(n, din, dh, dout, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = [((n, din), 1.0), ((din, dh), din ** -0.5), ((dh,), 0.1),
              ((dh, dout), dh ** -0.5), ((dout,), 0.1)]
    return [(torch.randn(s, generator=g) * sc).to("cuda", dtype)
            for s, sc in shapes]


def check_mlp2() -> dict:
    """mlp2 kernel vs mlp2_plain at the path shape, a ragged row count and
    a wide shape; float32 within 1e-5 of the output scale, bfloat16
    within 2e-2 (the plain version rounds its hidden layer to bfloat16,
    the kernel keeps it in float32)."""
    cases = [(16384, 16, 16, 1, "elu", "relu"),
             (16381, 16, 16, 1, "elu", "relu"),
             (16384, 35, 64, 32, "elu", "elu")]
    errs, rels = {}, {}
    for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        errs[dtype] = rels[dtype] = 0.0
        for i, (n, din, dh, dout, a1, a2) in enumerate(cases):
            args = mlp2_inputs(n, din, dh, dout, dtype, seed=i)
            got = fused_mlp.mlp2(*args, a1, a2)
            want = fused_mlp.mlp2_plain(*args, a1, a2)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            emit({"phase": "kernel_check", "kernel": "mlp2",
                  "dtype": str(dtype), "shape": [n, din, dh, dout],
                  "acts": [a1, a2], "max_abs_err": err, "scale": scale})
            if not err <= rel * scale:
                raise AssertionError(f"mlp2 {dtype} {n}x{din}->{dh}->{dout}"
                                     f": error {err} > {rel} x {scale}")
            errs[dtype] = max(errs[dtype], err)
            rels[dtype] = max(rels[dtype], err / scale)

    # time at the serving path's shape and dtype
    n, din, dh, dout = 16384, 16, 16, 1
    args = mlp2_inputs(n, din, dh, dout, torch.bfloat16, seed=9)

    def kernel():
        return fused_mlp.mlp2(*args, "elu", "relu")

    def plain():
        return fused_mlp.mlp2_plain(*args, "elu", "relu")
    # the plain version launches ~10 kernels a call: 50 calls stay inside
    # the device's queue of pending launches
    k_ms, p_ms = event_time_ms(kernel, 200), event_time_ms(plain, 50)
    k_prof_ms, p_prof_ms = profiler_time_ms(kernel), profiler_time_ms(plain)
    elt = 2
    nbytes = elt * (n * (din + dout) + din * dh + dh + dh * dout + dout)
    flops = 2 * n * (din * dh + dh * dout)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    row = {"name": "mlp2", "route": "cuda",
           "source": "panogrf_tpu_torch/csrc/fused_mlp.cu",
           "replaces": "panogrf_tpu/ops/pallas/fused_mlp.py:51",
           "launches": None,
           "max_abs_err": max(errs.values()),
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None,
           "max_err_fp32": errs[torch.float32],
           "max_err_bf16": errs[torch.bfloat16],
           "max_rel_err_fp32": rels[torch.float32],
           "max_rel_err_bf16": rels[torch.bfloat16],
           "kernel_us": k_ms * 1e3, "plain_us": p_ms * 1e3,
           "bound_us": max(t_bytes, t_ops) * 1e3,
           "profiler_ms": k_prof_ms, "plain_profiler_ms": p_prof_ms,
           "shape": [n, din, dh, dout], "dtype": "bfloat16"}
    emit({"phase": "kernel_time", **row})
    return row


# ---------------------------------------------------------------------------
# the serving render
# ---------------------------------------------------------------------------

def bench_inputs(h, w, dh, dw):
    """The inputs bench.py renders (same seed and construction)."""
    rng = np.random.default_rng(0)
    w2c = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
                  (RFN, 1, 1))
    w2c[1, 2, 3] = 1.0
    ref_info = {"imgs": rng.uniform(size=(RFN, h, w, 3)),
                "mvs_depth": rng.uniform(1.0, 6.0, size=(RFN, dh, dw, 1)),
                "depth_range": np.asarray([[0.5, 15.0]] * RFN),
                "w2c": w2c}
    c2w = np.concatenate([np.eye(3), [[0.0], [0.0], [0.5]]], 1)
    return ref_info, c2w, np.asarray([[0.5, 15.0]])


def render_full_width() -> dict:
    model = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW), **preset_kwargs("serving"),
        device="cuda", generator=torch.Generator().manual_seed(0))
    ref_info, c2w, qdr = bench_inputs(H, W, DH, DW)
    t0 = time.perf_counter()
    ref = full_render.prepare_ref_data(model, ref_info)
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    launches, first_rgb = {}, {}
    # the presets at their chunk, then serving at a 16x larger chunk
    # (chunking is pure blocking: fewer, larger launches of the same work)
    runs = [("serving", PRESET_CHUNK["serving"]),
            ("turbo", PRESET_CHUNK["turbo"]), ("serving", 4096)]
    for preset, chunk in runs:
        f = PRESET_COARSE_LOWRES[preset]
        # one mlp2 launch per chunk of the fine pass and of the coarse pass
        expected = H * W // chunk + (H // f) * (W // f) // chunk

        def frame():
            return full_render.render_image_device(
                model, ref, c2w, qdr, ref_info["depth_range"], chunk=chunk,
                coarse_lowres=f)
        torch.cuda.reset_peak_memory_stats()
        fused_mlp.MLP2_LAUNCHES = 0
        t0 = time.perf_counter()
        rgb = frame()                                  # warm-up, counted
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        count = fused_mlp.MLP2_LAUNCHES
        launches.setdefault(preset, count)
        first_rgb.setdefault(preset, rgb)
        peak = torch.cuda.max_memory_allocated()
        if tuple(rgb.shape) != (H, W, 3) or not torch.isfinite(rgb).all() \
                or rgb.min() < 0 or rgb.max() > 1:
            raise AssertionError(f"{preset}: bad frame {tuple(rgb.shape)}")
        if count != expected:
            raise AssertionError(f"{preset} chunk {chunk}: mlp2 launched "
                                 f"{count} times, expected {expected}")
        diff = (rgb - first_rgb[preset]).abs()
        dev_ms, host_ms = [], []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            frame()
            end.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        emit({"phase": "frame", "preset": preset, "hw": [H, W],
              "depth_hw": [DH, DW], "samples": [64, 64],
              "chunk": chunk, "coarse_lowres": f,
              "dtype": "bfloat16", "mlp2_launches": count,
              "ms_per_frame": statistics.median(dev_ms),
              "ms_per_frame_runs": dev_ms, "host_ms_runs": host_ms,
              "first_frame_ms": first_ms, "prepare_ref_ms": prep_ms,
              "peak_mem_bytes": peak,
              "rgb_mean": rgb.mean().item(), "rgb_std": rgb.std().item(),
              # bfloat16 products of other shapes may round differently
              "max_abs_diff_vs_preset_chunk": diff.max().item(),
              "mean_abs_diff_vs_preset_chunk": diff.mean().item()})
    for chunk, n_chunks in ((256, 16), (4096, 2)):
        profile_chunks(model, ref, c2w, qdr, ref_info["depth_range"], chunk,
                       n_chunks)
    return launches


def profile_chunks(model, ref, c2w, qdr, dr, chunk: int,
                   n_chunks: int) -> None:
    """Device time by kernel and by PyTorch operator over ``n_chunks``
    serving fine-pass chunks of ``chunk`` rays (torch.profiler), the host
    time by operator, and the share of the window the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    c2w_t, qdr_t, dr_t = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                          for x in (c2w, qdr, dr))
    ys, xs = torch.meshgrid(torch.arange(H // 2 - 4, H // 2 + 4, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    coords = torch.stack([xs, ys], -1).reshape(-1, 1, chunk, 2).float()
    hit = torch.rand(coords.shape[0], 1, chunk, 64, device=dev,
                     generator=torch.Generator(dev).manual_seed(0))

    def run():
        with torch.inference_mode():
            for i in range(n_chunks):
                model.render_fine_from_hit(ref, coords[i % len(coords)],
                                           hit[i % len(coords)], c2w_t,
                                           qdr_t, dr_t)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _cuda_kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::")]

    def top_ops(attr):
        ops.sort(key=lambda e: -getattr(e, attr))
        return [{"op": e.key, "us_per_chunk": getattr(e, attr) / n_chunks,
                 "calls_per_chunk": e.count / n_chunks} for e in ops[:8]]
    emit({"phase": "profile",
          "what": f"{n_chunks} serving fine chunks of {chunk} rays",
          "wall_us_per_chunk": wall_us / n_chunks,
          "device_busy_us_per_chunk": busy / n_chunks,
          "device_busy_share": busy / wall_us,
          "kernels_per_chunk": sum(r[2] for r in rows) / n_chunks,
          "top_kernels": [{"kernel": k[:80], "us_per_chunk": t / n_chunks,
                           "count_per_chunk": c / n_chunks}
                          for k, t, c in rows[:8]],
          "top_ops_device": top_ops("self_device_time_total"),
          "top_ops_host": top_ops("self_cpu_time_total")})


def cuda_vs_cpu() -> None:
    """The same seeded model renders a 64x128 serving frame (float32) on
    the card, through the kernels, and on the CPU, through the plain
    versions; rgb agrees within 2e-3."""
    h, w, dh, dw = 64, 128, 32, 64
    ref_info, c2w, qdr = bench_inputs(h, w, dh, dw)
    rgbs, launches = {}, 0
    for device in ("cuda", "cpu"):
        model = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=(dh, dw),
            **preset_kwargs("serving", compute_dtype="float32"),
            device=device, generator=torch.Generator().manual_seed(1))
        ref = full_render.prepare_ref_data(model, ref_info, device=device)
        before = fused_mlp.MLP2_LAUNCHES
        rgbs[device] = full_render.render_image_device(
            model, ref, c2w, qdr, ref_info["depth_range"], chunk=256,
            coarse_lowres=2, device=device).cpu()
        if device == "cuda":
            launches = fused_mlp.MLP2_LAUNCHES - before
    err = (rgbs["cuda"] - rgbs["cpu"]).abs().max().item()
    emit({"phase": "cuda_vs_cpu", "hw": [h, w], "dtype": "float32",
          "mlp2_launches_cuda": launches, "max_abs_err_rgb": err,
          "rgb_std": rgbs["cpu"].std().item()})
    if launches == 0 or not err <= 2e-3:
        raise AssertionError(f"cuda vs cpu: err {err}, launches {launches}")


def main() -> int:
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

    _build.load_library()
    info = _build.BUILD_INFO
    emit({"phase": "build", "seconds": info["seconds"],
          "sources": info["sources"],
          "ptxas": [ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln]})

    row = check_mlp2()
    launches = render_full_width()
    row["launches"] = launches["serving"]
    row["launches_turbo"] = launches["turbo"]
    cuda_vs_cpu()
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": [row]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
