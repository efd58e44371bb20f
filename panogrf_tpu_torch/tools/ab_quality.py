"""Quality A/B of the renderer's operating points on one set of weights.

    python -m panogrf_tpu_torch.tools.ab_quality [--ckpt model.pth] \\
        [--steps N] [--train-mode hierarchical|diner[N][_muK|_cuK]] \\
        [--count-jitter 64,48,32] [--height H --width W] [--num N] \\
        [--modes exact,fast_gather,bf16,light_coarse,diner] \\
        [--save-ckpt model.pth] [--out table.json] [--device cpu]

Port of the repo's ``tools/ab_quality.py``.  Renders the same held-out
procedural scenes under each mode of ``--modes`` with one set of weights
and prints the mean PSNR / SSIM / WS-PSNR of each (LPIPS is not computed).
The modes are the table ``MODE_CFGS`` (``exact``, ``fast_gather``,
``bf16``, ``light_coarse``, strides, decode-on-map, the presets,
``nearest``, reduced sample counts, ``diner``) and two grammars:
``diner[N][_muK|_cuK]`` (DINER frames from N candidates, default 128,
merged with a K-sample uniform pass, or with K uniform samples added
before the pass) and ``clr<f>[_fN]`` (the serving preset with the coarse
pass on an (H/f, W/f) grid, optionally N fine samples).

Without ``--ckpt`` a renderer is first trained from scratch for
``--steps`` Adam steps of the render loss on 8 procedural scenes (512
rays a step), under hierarchical sampling or, with ``--train-mode
diner...``, under DINER's depth-guided sampling (no fine heads: evaluate
DINER modes only then).  ``--count-jitter`` draws the fine sample count
of each step from its list (duplicates weight the draw).  ``--ckpt`` and
``--save-ckpt`` read and write a renderer ``model.pth`` in the reference
layout; ``--ckpt`` also reads an orbax directory of the JAX trainer.  It
runs on the CUDA device and raises without one unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.presets import PRESET_COARSE_LOWRES, PRESETS
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import (Trainer, TrainerConfig,
                                             load_checkpoint_params)
from panogrf_tpu_torch.utils.device import resolve_device

DINER_MODE = re.compile(r"diner(\d*)(?:_(mu|cu)(\d+))?")
CLR_MODE = re.compile(r"clr(\d+)(?:_f(\d+))?")
TRAIN_RAYS = 512

_BF16 = {"fast_gather": True, "compute_dtype": "bfloat16"}
MODE_CFGS = {
    "exact": {},
    "fast_gather": {"fast_gather": True},
    "bf16": _BF16,
    "light_coarse": {**_BF16, "light_coarse": True},
    "coarse16": {**_BF16, "depth_sample_num": 16},
    "coarse32": {**_BF16, "depth_sample_num": 32},
    "s2": {**_BF16, "gather_stride": 2},
    "s4": {**_BF16, "gather_stride": 4},
    "s8": {**_BF16, "gather_stride": 8},
    "dmap": {**_BF16, "gather_stride": 4, "decode_on_map": True},
    "s4f8": {**_BF16, "gather_stride": 4, "gather_stride_fine": 8},
    "dmap_s4f8": {**_BF16, "gather_stride": 4, "gather_stride_fine": 8,
                  "decode_on_map": True},
    "dmap_s8f8": {**_BF16, "gather_stride": 8, "gather_stride_fine": 8,
                  "decode_on_map": True},
    "dmap_s8f4": {**_BF16, "gather_stride": 8, "gather_stride_fine": 4,
                  "decode_on_map": True},
    "dmap_s4f16": {**_BF16, "gather_stride": 4, "gather_stride_fine": 16,
                   "decode_on_map": True},
    "dmap_s4f32": {**_BF16, "gather_stride": 4, "gather_stride_fine": 32,
                   "decode_on_map": True},
    # the presets' model flags; their coarse_lowres is the clr<f> modes'
    # (turbo renders at its own factor)
    "serving": dict(PRESETS["serving"]),
    "turbo": dict(PRESETS["turbo"]),
    "nearest": {**PRESETS["serving"], "gather_nearest": True},
    "nearest_f48": {**PRESETS["serving"], "gather_nearest": True,
                    "fine_depth_sample_num": 48},
    "serving_f48": {**PRESETS["serving"], "fine_depth_sample_num": 48},
    "serving_f32": {**PRESETS["serving"], "fine_depth_sample_num": 32},
    "serving_c48f48": {**PRESETS["serving"], "depth_sample_num": 48,
                       "fine_depth_sample_num": 48},
    "diner": _BF16,
    "diner1000": _BF16,
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="renderer model.pth, or an orbax directory of "
                         "the JAX trainer")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth-height", type=int, default=64)
    ap.add_argument("--depth-width", type=int, default=128)
    ap.add_argument("--num", type=int, default=4)
    ap.add_argument("--m3d-dist", type=float, default=0.5)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--fine-samples", type=int, default=0,
                    help="fine sample count of training and evaluation "
                         "(0 = --samples)")
    ap.add_argument("--proxy-samples", type=int, default=0,
                    help="light_coarse's proxy sample count (0 = --samples)")
    ap.add_argument("--count-jitter", default="",
                    help="comma list of fine sample counts, one drawn per "
                         "training step (duplicates weight the draw)")
    ap.add_argument("--modes", default="exact,fast_gather,bf16,"
                                       "light_coarse,diner")
    ap.add_argument("--train-mode", default="hierarchical",
                    help="'hierarchical' or 'diner[N][_muK|_cuK]' (the "
                         "model then has no fine heads: DINER modes only)")
    ap.add_argument("--save-ckpt", default=None,
                    help="write the trained weights here (model.pth)")
    ap.add_argument("--out", default=None, help="write the table as JSON")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def _diner_counts(match: re.Match) -> dict:
    kind, k = match.group(2), int(match.group(3) or 0)
    return {"n_candidates": int(match.group(1) or 128),
            "n_uniform": k if kind == "mu" else 0,
            "contain_uniform": k if kind == "cu" else 0}


def train_kwargs(train_mode: str) -> dict:
    """Renderer flags of the training sampler ``train_mode``."""
    if train_mode == "hierarchical":
        return {}
    g = DINER_MODE.fullmatch(train_mode)
    if not g:
        raise ValueError(f"bad --train-mode {train_mode!r}")
    c = _diner_counts(g)
    return {"sampling_mode": "diner", "use_hierarchical_sampling": False,
            "diner_n_candidates": c["n_candidates"],
            "diner_n_uniform": c["n_uniform"],
            "diner_contain_uniform": c["contain_uniform"]}


def mode_config(mode: str) -> dict:
    """Renderer flags of an evaluation mode."""
    if mode in MODE_CFGS:
        return dict(MODE_CFGS[mode])
    if DINER_MODE.fullmatch(mode):
        return dict(_BF16)
    g = CLR_MODE.fullmatch(mode)
    if g:
        cfg = dict(PRESETS["serving"])
        if g.group(2):
            cfg["fine_depth_sample_num"] = int(g.group(2))
        return cfg
    raise ValueError(f"unknown mode {mode!r}; modes: {sorted(MODE_CFGS)}, "
                     "diner[N][_muK|_cuK], clr<f>[_fN]")


def build(args: argparse.Namespace, log_fn=None) -> tuple:
    """(make_model, the weights' model, the trainer and its batch stream,
    or None and None with ``--ckpt``).  ``make_model(**flags)`` builds a
    renderer of the run's sizes, counts and training sampler."""
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    dhw = (args.depth_height, args.depth_width)
    base_kw = dict(height=h, width=w, depth_hw=dhw,
                   depth_sample_num=args.samples,
                   fine_depth_sample_num=args.fine_samples or args.samples,
                   coarse_proxy_samples=args.proxy_samples,
                   **train_kwargs(args.train_mode))

    def make_model(**kw) -> NeuralRayGenRenderer:
        return NeuralRayGenRenderer(
            **{**base_kw, **kw}, device=dev,
            generator=torch.Generator().manual_seed(0))

    model = make_model()
    if args.ckpt:
        model.load_state_dict(load_checkpoint_params(args.ckpt))
        print(f"restored {args.ckpt}")
        return make_model, model, None, None
    rng = np.random.default_rng(0)
    # the JAX tool draws its init batch's rays first; drawing them keeps
    # the training stream equal to its
    imgs_info.sample_train_coords(rng, h, w, TRAIN_RAYS)
    pool = [make_three_view_sample(SphereScene.random(100 + i, device=dev),
                                   h, w, args.m3d_dist, seed=i)
            for i in range(8)]

    def stream():
        while True:
            s = pool[int(rng.integers(len(pool)))]
            c = imgs_info.sample_train_coords(rng, h, w, TRAIN_RAYS,
                                              device=dev)
            data = imgs_info.build_render_sample(s, c, src_for_mvs=False)
            data["ref_imgs_info"]["mvs_depth"] = resize_linear(
                s["depth_panos"][list(imgs_info.REF_IDS)], dhw, axes=(1, 2))
            yield data

    cfg = TrainerConfig(total_step=args.steps, val_interval=10**9,
                        save_interval=10**9, losses=("render",),
                        log_interval=100,
                        lr_cfg={"lr_init": 4e-4, "decay_step": 10**9,
                                "decay_rate": 0.5})
    probs = None
    if args.count_jitter:
        counts = [int(c) for c in args.count_jitter.split(",")]
        probs = {f"f{c}": counts.count(c) for c in set(counts)}
        forward = {f"f{c}": (lambda b, g, _c=c: model(b, g, _c))
                   for c in set(counts)}
    else:
        def forward(b, g):
            return model(b, g)

    def log(step, m):
        print(f"train {step}: loss={m['loss']:.4f}", flush=True)
        if log_fn is not None:
            log_fn(step, m)

    trainer = Trainer(model, forward, cfg, log_fn=log, variant_probs=probs)
    return make_model, model, trainer, stream()


def evaluate(args: argparse.Namespace, make_model, weights: dict) -> dict:
    """{mode: mean metrics over ``--num`` held-out scenes} of the
    renderer's ``weights`` (a state dict) under each mode."""
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    dhw = (args.depth_height, args.depth_width)
    scenes = [make_three_view_sample(SphereScene.random(9000 + i, device=dev),
                                     h, w, args.m3d_dist, seed=100 + i)
              for i in range(args.num)]
    qdr = [[0.5, 15.0]]
    q = imgs_info.QUE_ID
    table = {}
    for mode in args.modes.split(","):
        model = make_model(**mode_config(mode))
        model.load_state_dict(weights)
        model.eval()
        vals = []
        for s in scenes:
            ref_info = imgs_info.build_imgs_info(s, imgs_info.REF_IDS,
                                                 (0.5, 15.0))
            ref_info["mvs_depth"] = resize_linear(
                s["depth_panos"][list(imgs_info.REF_IDS)], dhw, axes=(1, 2))
            c2w = imgs_info.c2w_from_w2c(
                imgs_info.pose_w2c(s["rots"], s["trans"])[q][None])[0]
            diner, clr = DINER_MODE.fullmatch(mode), CLR_MODE.fullmatch(mode)
            if diner or clr or mode == "turbo":
                ref_data = full_render.prepare_ref_data(model, ref_info,
                                                        device=dev)
                if diner:
                    ref_data["mvs_uncert"] = torch.full_like(
                        ref_info["mvs_depth"], 0.04)
                    kw = {"mode": "diner", **_diner_counts(diner)}
                else:
                    kw = {"coarse_lowres": int(clr.group(1)) if clr
                          else PRESET_COARSE_LOWRES["turbo"]}
                rgb = full_render.render_image_device(
                    model, ref_data, c2w, qdr, ref_info["depth_range"],
                    chunk=min(2048, h * w), device=dev, **kw)
            else:
                rgb = full_render.render_image(
                    model, ref_info, c2w, qdr, chunk=min(8192, h * w),
                    device=dev)["rgb"]
            m = M.render_metrics(rgb, s["rgb_panos"][q])
            vals.append({k: float(v) for k, v in m.items()})
        table[mode] = {k: round(float(np.mean([v[k] for v in vals])), 4)
                       for k in vals[0]}
        print(f"{mode:14s} " + " ".join(f"{k}={v:.3f}"
                                        for k, v in table[mode].items()))
    return table


def main(argv=None, log_fn=None) -> dict:
    """Run the tool on ``argv``; returns the table.  ``log_fn`` (step,
    metrics) sees every logged training step."""
    args = parse_args(argv)
    make_model, model, trainer, stream = build(args, log_fn)
    if trainer is not None:
        trainer.fit(stream, args.steps)
        if args.save_ckpt:
            path = Path(args.save_ckpt)
            path.parent.mkdir(parents=True, exist_ok=True)
            torch.save({"step": trainer.step,
                        "network_state_dict": model.state_dict()}, path)
            print(f"saved params -> {path}")
    table = evaluate(args, make_model, model.state_dict())
    if args.out:
        Path(args.out).write_text(json.dumps(table, indent=2))
    print(json.dumps(table))
    return table


if __name__ == "__main__":
    main()
