"""Parity harness for released checkpoints: load, render, report.

    python -m panogrf_tpu_torch.tools.parity_check --renderer-pth model.pth \\
        [--mono-pth checkpoint_100000.pt] [--mvs-pth mvs.pt] \\
        [--shards data/shards/test] [--expected-psnr 28.6] [--num 8] \\
        [--lpips-weights lpips_vgg.npz] [--key-check-only] [--device cpu]

Port of the repo's ``tools/parity_check.py``, for the reference's three
released files (UniFuse, the 360-degree MVS net, the renderer's
``model.pth``) or the port's trainers' own:

  1. load   each file's state dict into a fresh port module, key by key:
            every missing, unexpected and mis-shaped key is listed and any
            aborts (exit 1).  The port uses the reference key layout, so
            nothing is converted; an MVS file's head sets the net's
            hypotheses and its frozen mono net (``d_net.*``) is held to
            UniFuse.
  2. render the COMPOSED pipeline (mono -> MVS -> renderer, no true depth)
            through the render CLI with the ``exact`` preset, on
            ``--shards`` samples (imported reference data) or procedural
            scenes.
  3. report the metric stack (PSNR / SSIM / WS-PSNR [/ LPIPS]) against
            ``--expected-psnr`` (the reference's number on the same
            scenes): a PSNR more than ``--gate-db`` (0.1 dB) below it
            exits 1.

It runs on the CUDA device and raises without one unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from torch import nn

from panogrf_tpu_torch.models.depth_stack import (extract_dnet,
                                                  read_checkpoint)
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.models.unifuse import UniFuse
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools import render
from panogrf_tpu_torch.train.trainer import load_checkpoint_params
from panogrf_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--renderer-pth", required=True)
    ap.add_argument("--mono-pth", default=None)
    ap.add_argument("--mvs-pth", default=None)
    ap.add_argument("--shards", default=None,
                    help="imported reference shards (real data); omit for "
                         "procedural scenes")
    ap.add_argument("--num", type=int, default=8)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--depth-height", type=int, default=256)
    ap.add_argument("--depth-width", type=int, default=512)
    ap.add_argument("--expected-psnr", type=float, default=None,
                    help="the reference's PSNR on the same scenes")
    ap.add_argument("--gate-db", type=float, default=0.1)
    ap.add_argument("--lpips-weights", default=None)
    ap.add_argument("--out", default="data/parity_out")
    ap.add_argument("--key-check-only", action="store_true",
                    help="stop after step 1")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def key_problems(name: str, sd: dict, module: nn.Module) -> list:
    """The keys of ``sd`` against ``module``'s state dict: missing (a
    BatchNorm's ``num_batches_tracked`` may be), unexpected and mis-shaped;
    prints them.  A clean ``sd`` is loaded into ``module``."""
    own = module.state_dict()
    problems = [f"missing {k}" for k in sorted(own.keys() - sd.keys())
                if not k.endswith("num_batches_tracked")]
    problems += [f"unexpected {k}" for k in sorted(sd.keys() - own.keys())]
    problems += [f"shape {k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
                 for k in sorted(own.keys() & sd.keys())
                 if tuple(sd[k].shape) != tuple(own[k].shape)]
    print(f"[load] {name}: "
          + ("OK" if not problems else f"{len(problems)} PROBLEMS"))
    for p in problems[:20]:
        print("   ", p)
    if not problems:
        module.load_state_dict({k: sd.get(k, v) for k, v in own.items()})
    return problems


def load_check(args: argparse.Namespace) -> list:
    """Step 1 on the CPU: every given file against a fresh module."""
    problems = []
    if args.mono_pth:
        problems += key_problems("mono (UniFuse)",
                                 read_checkpoint(args.mono_pth), UniFuse())
    if args.mvs_pth:
        sd = read_checkpoint(args.mvs_pth)
        dnet = extract_dnet(sd)
        sd = {k: v for k, v in sd.items() if not k.startswith("d_net.")}
        head = sd.get("decoders1.conv.weight")
        final = sd.get("decoders2.2.conv2.weight")
        mvs = MVSDepthModel(
            num_hypotheses=64 if head is None else head.shape[1],
            mvs_uncertainty=final is not None and final.shape[0] == 2)
        problems += key_problems("mvs (360-MVSNet)", sd, mvs)
        if dnet:
            problems += key_problems("mvs d_net (UniFuse)", dnet, UniFuse())
    model = NeuralRayGenRenderer(
        height=args.height, width=args.width,
        depth_hw=(args.depth_height, args.depth_width), device="cpu")
    problems += key_problems("renderer (NeuralRayGen)",
                             load_checkpoint_params(args.renderer_pth), model)
    return problems


def main(argv=None) -> int:
    """Run the three steps on ``argv``; returns the exit code (0: the files
    load cleanly and the PSNR, when expected, is within the gate)."""
    args = parse_args(argv)
    resolve_device(args.device)     # the render step's; raise early
    problems = load_check(args)
    if problems:
        print(f"\nFAIL: {len(problems)} key problems")
        return 1
    print("all checkpoints load cleanly")
    if args.key_check_only:
        return 0

    out = Path(args.out)
    argv_r = ["--ckpt", args.renderer_pth, "--num", str(args.num),
              "--height", str(args.height), "--width", str(args.width),
              "--depth-height", str(args.depth_height),
              "--depth-width", str(args.depth_width), "--out", str(out),
              "--exact", "--no-skip", "--device", args.device]
    if args.mono_pth:
        argv_r += ["--mono-ckpt", args.mono_pth]
    if args.mvs_pth:
        argv_r += ["--mvs-ckpt", args.mvs_pth]
    elif args.mono_pth:
        argv_r += ["--wo-stereo"]
    if args.shards:
        argv_r += ["--shards", args.shards]
    if args.lpips_weights:
        argv_r += ["--lpips-weights", args.lpips_weights]
    print("[render]", " ".join(argv_r))
    render.main(argv_r)

    metric_file = out / "metric.txt"
    if not metric_file.exists():
        print("FAIL: no metric.txt produced")
        return 1
    mean = json.loads(metric_file.read_text())
    print("[report]", json.dumps(mean))
    if args.expected_psnr is None:
        return 0
    psnr = mean.get("psnr_nr_fine", mean.get("psnr_nr"))
    delta = psnr - args.expected_psnr
    ok = abs(delta) <= args.gate_db or delta > 0
    print(f"[report] PSNR {psnr:.3f} vs expected {args.expected_psnr:.3f} "
          f"(delta {delta:+.3f} dB, gate +-{args.gate_db}) -> "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
