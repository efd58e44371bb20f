"""Score rendered image directories: PSNR / SSIM / WS-PSNR / LPIPS.

    python -m panogrf_tpu_torch.tools.eval_dirs --dir_gt render/gt \\
        --dir_pr render/pred [--lpips-weights lpips_vgg.npz] [--device cpu]

Port of the repo's ``tools/eval_dirs.py``: reads the ground-truth images
``{k}.png|jpg`` (the reference's layout) or ``{k}-gt.png|jpg`` (the render
CLI's, beside its renders) of ``--dir_gt`` and the renders
``{k}-nr_fine.png|jpg`` of ``--dir_pr``, averages ``train/metrics.
render_metrics`` (and LPIPS with ``--lpips-weights``, else null) over the
pairs and writes the mean to ``--dir_pr``/``metric.txt``.  It runs on the
CUDA device and raises without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.train import lpips as L
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.utils.device import resolve_device


def load_image(path: Path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path), np.float32) / 255.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir_gt", required=True)
    ap.add_argument("--dir_pr", required=True)
    ap.add_argument("--lpips-weights", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict | None:
    """Score the directories of ``argv``; returns the mean metrics (None
    when no pair was found)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    lpips_score = None
    if args.lpips_weights:
        lpips_score = L.lpips_fn(L.load_lpips_weights(args.lpips_weights,
                                                      dev))
    dir_gt, dir_pr = Path(args.dir_gt), Path(args.dir_pr)
    gts = sorted(dir_gt.glob("*.png")) + sorted(dir_gt.glob("*.jpg"))
    # never the renders themselves, which may share the directory
    gts = [p for p in gts if "-" not in p.stem or p.stem.endswith("-gt")]
    rows = []
    for gt_path in gts:
        k = gt_path.stem.split("-")[0]
        cands = [dir_pr / f"{k}-nr_fine{ext}" for ext in (".png", ".jpg")]
        pr_path = next((c for c in cands if c.exists()), None)
        if pr_path is None:
            print(f"skip {k}: no render found")
            continue
        gt = torch.as_tensor(load_image(gt_path), device=dev)
        pr = torch.as_tensor(load_image(pr_path), device=dev)
        m = {kk: float(v) for kk, v in M.render_metrics(pr, gt).items()}
        if lpips_score is not None:
            m["lpips"] = float(lpips_score(gt[None], pr[None])[0])
        rows.append(m)
        print(k, " ".join(f"{kk}={v:.4f}" for kk, v in m.items()))

    if not rows:
        print("no image pairs found")
        return None
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    if lpips_score is None:
        mean["lpips"] = None
    msg = json.dumps(mean, indent=2)
    (dir_pr / "metric.txt").write_text(msg)
    print("mean:", msg)
    return mean


if __name__ == "__main__":
    main()
