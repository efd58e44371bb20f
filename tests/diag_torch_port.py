"""Diagnostics behind two facts the port's CPU checks rely on (CPU only).

    python tests/diag_torch_port.py exp-threads [--procs N] [--threads T]
        [--calls C] [--no-jax]
    python tests/diag_torch_port.py exp-loop [--calls N]
    python tests/diag_torch_port.py vml-modes
    python tests/diag_torch_port.py seam-step

``exp-threads`` starts N fresh processes, 6 at a time; each runs the JAX
package's ``mlp2`` once (Pallas interpret; not with ``--no-jax``) and then
C times the port's ELU step ``exp(min(x @ W1 + b1, 0))`` with torch at T
threads, and reports, per call, the elements whose ``exp`` is off float64
by more than 1e-6 relative.  It prints one JSON summary: processes,
processes with a fault, and for each of those the rows and worst relative
error of each call.  ``exp-loop`` repeats the same ``exp`` N times inside
one process.  ``vml-modes`` evaluates MKL's
``vmsExp`` (the library behind torch's CPU ``exp``) in its three accuracy
modes on the same inputs and says which one torch matches bit for bit.
``tests/torch_port_threads.py`` rests on these three.

``seam-step`` runs one CPU training step of the port at 64x128 in float32
and in float64, with random rays over the whole image and with rays off
its border rows and columns, and prints the loss of each; ``chip_smoke.py``'s
``train_cuda_vs_cpu`` keeps its rays off the border for the reason this
shows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
N, DIN, DH = 5000, 35, 64


def _elu_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIN)).astype(np.float32)
    w1 = (rng.normal(size=(DIN, DH)) * DIN ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=(DH,)) * 0.1).astype(np.float32)
    return x, w1, b1


def _bad_exp(c, e) -> dict | None:
    """Rows and worst relative error where ``e`` is off exp(c)."""
    rel = np.abs(e.astype(np.float64) / np.exp(c.astype(np.float64)) - 1)
    bad = np.argwhere(rel > 1e-6)
    if not len(bad):
        return None
    return {"rows": [int(bad[:, 0].min()), int(bad[:, 0].max())],
            "elements": len(bad), "max_rel_err": float(rel.max())}


def child(threads: int, with_jax: bool, calls: int) -> None:
    sys.path.insert(0, str(ROOT))
    x, w1, b1 = _elu_inputs()
    if with_jax:
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from panogrf_tpu.ops.pallas import fused_mlp as jmlp
        w2 = np.ones((DH, 4), np.float32) * 0.1
        jmlp.mlp2(*map(jnp.asarray, (x, w1, b1, w2,
                                     np.zeros(4, np.float32))),
                  "elu", "elu", 1024, True).block_until_ready()
    import torch
    torch.set_num_threads(threads)
    c = torch.clamp(torch.tensor(x) @ torch.tensor(w1) + torch.tensor(b1),
                    max=0.0)
    print(json.dumps([_bad_exp(c.numpy(), torch.exp(c).numpy())
                      for _ in range(calls)]))


def exp_threads(procs: int, threads: int, with_jax: bool,
                calls: int) -> None:
    faults, done = [], 0
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, __file__, "child", "--threads", str(threads),
           "--calls", str(calls)] + ([] if with_jax else ["--no-jax"])
    while done < procs:
        batch = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True,
                                  env=env)
                 for _ in range(min(6, procs - done))]
        for p in batch:
            out = p.communicate()[0].strip().splitlines()
            if p.returncode != 0 or not out:
                raise RuntimeError(f"child failed with {p.returncode}")
            per_call = json.loads(out[-1])
            if any(per_call):
                faults.append(per_call)
        done += len(batch)
    print(json.dumps({"processes": procs, "threads": threads,
                      "jax_first": with_jax, "calls_per_process": calls,
                      "processes_with_fault": len(faults),
                      "faults": faults}))


def exp_loop(calls: int) -> None:
    import torch
    x, w1, b1 = _elu_inputs()
    c = torch.clamp(torch.tensor(x) @ torch.tensor(w1) + torch.tensor(b1),
                    max=0.0)
    bad = [i for i in range(calls)
           if _bad_exp(c.numpy(), torch.exp(c).numpy()) is not None]
    print(json.dumps({"calls": calls, "threads": torch.get_num_threads(),
                      "calls_with_fault": len(bad)}))


def vml_modes() -> None:
    import ctypes
    import torch
    lib = ctypes.CDLL(str(Path(torch.__file__).parent / "lib"
                          / "libtorch_cpu.so"))
    x, w1, b1 = _elu_inputs()
    c = np.ascontiguousarray(np.minimum(x @ w1 + b1, 0), np.float32).ravel()
    exact = np.exp(c.astype(np.float64))
    got = torch.exp(torch.tensor(c)).numpy()
    res = {"torch_max_rel_err": float(np.abs(got / exact - 1).max())}
    for name, mode in (("LA", 1), ("HA", 2), ("EP", 3)):
        out = np.empty_like(c)
        lib.vmsExp(ctypes.c_longlong(c.size), c.ctypes.data_as(
            ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_longlong(mode))
        res[name] = {"max_rel_err": float(np.abs(out / exact - 1).max()),
                     "equals_torch": bool(np.array_equal(out, got))}
    print(json.dumps(res))


def seam_step() -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    from panogrf_tpu_torch.data import imgs_info
    from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                                  make_three_view_sample)
    from panogrf_tpu_torch.nn.blocks import resize_linear
    from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
    from panogrf_tpu_torch.train import trainer as T
    h, w, dh, dw, dn = 64, 128, 32, 64, 32
    sample = make_three_view_sample(SphereScene.random(5), h, w, 1.0, seed=5)
    rays = {"whole_image": imgs_info.sample_train_coords(
                np.random.default_rng(5), h, w, 512),
            "off_border": imgs_info.sample_train_coords(
                np.random.default_rng(5), h - 2, w - 2, 512) + 1}
    cfg = T.TrainerConfig(losses=("render", "depth"), seed=5)
    res = {}
    for which, coords in rays.items():
        loss = {}
        for dt in (torch.float32, torch.float64):
            model = NeuralRayGenRenderer(
                height=h, width=w, depth_hw=(dh, dw), depth_sample_num=dn,
                fine_depth_sample_num=dn, gather_depth_major=True,
                device="cpu", generator=torch.Generator().manual_seed(5)
            ).to(dt)
            s = {k: v.to(dt) for k, v in sample.items()}
            data = imgs_info.build_render_sample(s, coords.to(dt),
                                                 src_for_mvs=False)
            data["ref_imgs_info"]["mvs_depth"] = resize_linear(
                s["depth_panos"][list(imgs_info.REF_IDS)], (dh, dw),
                axes=(1, 2))
            opt, sch = T.make_optimizer(cfg, model.parameters())
            step = T.make_train_step(lambda b, g: model(b, g), cfg, opt, sch)
            loss[str(dt)] = float(step(data, torch.Generator().manual_seed(5),
                                       0)["loss"])
        l32, l64 = loss.values()
        res[which] = {**loss, "rel_diff": abs(l32 - l64) / abs(l64)}
    print(json.dumps(res))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["exp-threads", "exp-loop", "vml-modes",
                                     "seam-step", "child"])
    ap.add_argument("--procs", type=int, default=240)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--calls", type=int, default=None,
                    help="exp calls per process (exp-threads: 1, "
                         "exp-loop: 3000)")
    ap.add_argument("--no-jax", action="store_true",
                    help="exp-threads: skip the JAX call before torch's")
    args = ap.parse_args()
    if args.what == "child":
        child(args.threads, not args.no_jax, args.calls or 1)
    elif args.what == "exp-threads":
        exp_threads(args.procs, args.threads, not args.no_jax,
                    args.calls or 1)
    elif args.what == "exp-loop":
        exp_loop(args.calls or 3000)
    elif args.what == "vml-modes":
        vml_modes()
    else:
        seam_step()


if __name__ == "__main__":
    main()
