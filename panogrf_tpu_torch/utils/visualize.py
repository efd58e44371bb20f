"""Validation image dumps of training runs.

Port of ``panogrf_tpu/utils/visualize.py``: a renderer validation writes a
``gt | pred`` side-by-side (and a turbo depth map), a depth-net validation
an ``[rgb |] gt | pred | error`` turbo sheet, under the run directory
(``{save_dir}/{name}/vis/``).  Host-side numpy only: callers pass host
arrays (``tensor.cpu().numpy()``).  The Turbo palette is matplotlib's LUT
when matplotlib is installed, else a 5th-order polynomial fit; PNGs are
written with imageio when it is installed, else the image is saved as
``.npy`` beside the requested path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# Google's Turbo colormap — the palette the reference gets from
# matplotlib in its depth dumps.  Use matplotlib's exact LUT when
# available; fall back to a 5th-order polynomial fit (mid-range accurate,
# endpoints slightly desaturated) in minimal environments.
_TURBO_R = (0.13572138, 4.61539260, -42.66032258, 132.13108234,
            -152.94239396, 59.28637943)
_TURBO_G = (0.09140261, 2.19418839, 4.84296658, -14.18503333,
            4.27729857, 2.82956604)
_TURBO_B = (0.10667330, 12.64194608, -60.58204836, 110.36276771,
            -89.90310912, 27.34824973)

try:
    from matplotlib import colormaps as _mpl_cmaps
    _TURBO_LUT = np.asarray(_mpl_cmaps["turbo"](np.linspace(0, 1, 256)))[
        :, :3].astype(np.float32)
except ImportError:
    _TURBO_LUT = None


def turbo_colormap(x: np.ndarray) -> np.ndarray:
    """Map values in [0, 1] to Turbo RGB in [0, 1]: (...,) -> (..., 3)."""
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    if _TURBO_LUT is not None:
        idx = np.clip((x * 255.0).round().astype(np.int64), 0, 255)
        return _TURBO_LUT[idx]
    powers = np.stack([x ** i for i in range(6)], axis=-1)
    rgb = np.stack([powers @ np.asarray(c) for c in
                    (_TURBO_R, _TURBO_G, _TURBO_B)], axis=-1)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def depth_turbo(depth: np.ndarray, d_min: float | None = None,
                d_max: float | None = None) -> np.ndarray:
    """Turbo-colormapped depth image (H, W[, 1]) -> (H, W, 3).

    Without an explicit range, normalizes by the robust (2%, 98%)
    percentiles so one outlier pixel doesn't flatten the map (the
    reference normalizes by the config max_depth; pass ``d_max`` to
    reproduce that).
    """
    d = np.asarray(depth, np.float32)
    if d.ndim == 3:
        d = d[..., 0]
    lo = float(np.percentile(d, 2)) if d_min is None else d_min
    hi = float(np.percentile(d, 98)) if d_max is None else d_max
    if hi <= lo:
        hi = lo + 1e-6
    return turbo_colormap((d - lo) / (hi - lo))


def error_turbo(pred: np.ndarray, gt: np.ndarray,
                scale: float | None = None) -> np.ndarray:
    """Turbo-colormapped |pred - gt| map; ``scale`` saturates the palette
    (default: the 98th-percentile error)."""
    p, g = np.asarray(pred, np.float32), np.asarray(gt, np.float32)
    if p.ndim == 3 and p.shape[-1] == 1:
        p, g = p[..., 0], g[..., 0]
    err = np.abs(p - g)
    if err.ndim == 3:           # rgb error -> mean over channels
        err = err.mean(-1)
    s = float(np.percentile(err, 98)) if scale is None else scale
    return turbo_colormap(err / max(s, 1e-6))


def save_png(path: Path | str, img: np.ndarray) -> Path:
    """Write a float [0,1] (H, W, 3) image as PNG (npy fallback)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(np.clip(np.asarray(img) * 255.0, 0, 255), np.uint8)
    try:
        import imageio.v2 as imageio
    except ImportError:
        path = path.with_suffix(".npy")
        np.save(path, arr)
    else:
        imageio.imwrite(path, arr)
    return path


def hstack_images(*imgs: np.ndarray, pad: int = 2) -> np.ndarray:
    """Concatenate (H, W, 3) images horizontally with a white separator."""
    imgs = [np.asarray(im, np.float32) for im in imgs]
    h = max(im.shape[0] for im in imgs)
    cols = []
    for i, im in enumerate(imgs):
        if im.shape[0] != h:    # pad shorter panels at the bottom
            im = np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)),
                        constant_values=1.0)
        if i:
            cols.append(np.ones((h, pad, 3), np.float32))
        cols.append(im)
    return np.concatenate(cols, axis=1)


def dump_render_val(vis_dir: Path | str, step: int, idx: int,
                    gt_rgb: np.ndarray, pred_rgb: np.ndarray,
                    pred_depth: np.ndarray | None = None) -> list:
    """Validation dump for the renderer: ``gt | pred`` side-by-side (+
    turbo depth when the render returned one).  Reference
    ``network/metrics.py:287-361`` VisualizeImage."""
    vis_dir = Path(vis_dir)
    out = [save_png(vis_dir / f"step{step:06d}-{idx}-gt_pred.png",
                    hstack_images(np.asarray(gt_rgb), np.asarray(pred_rgb)))]
    if pred_depth is not None:
        out.append(save_png(vis_dir / f"step{step:06d}-{idx}-depth.png",
                            depth_turbo(np.asarray(pred_depth))))
    return out


def dump_depth_val(vis_dir: Path | str, step: int, idx: int,
                   rgb: np.ndarray | None, gt_depth: np.ndarray,
                   pred_depth: np.ndarray,
                   d_max: float | None = None) -> Path:
    """Validation dump for the depth nets: ``[rgb |] gt | pred | error``
    sheet in turbo (reference ``train_depth.py:456-580``)."""
    panels = [] if rgb is None else [np.asarray(rgb, np.float32)]
    panels += [depth_turbo(gt_depth, d_min=0.0, d_max=d_max),
               depth_turbo(pred_depth, d_min=0.0, d_max=d_max),
               error_turbo(pred_depth, gt_depth)]
    return save_png(Path(vis_dir) / f"step{step:06d}-{idx}-depth.png",
                    hstack_images(*panels))
