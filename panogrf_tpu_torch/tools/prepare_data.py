"""Pre-render a panorama dataset into array shards.

    python -m panogrf_tpu_torch.tools.prepare_data --out data/shards_train \\
        [--num 256] [--height 256 --width 512] [--m3d-dist 0.5] [--seed 0] \\
        [--cubes [--split train|val|test] [--seq-len 3]] [--device cpu]

Port of the repo's ``tools/prepare_data.py``, the stand-in for the
reference's LMDB writer (``lmdb_rw_render/lmdb_write_render.py``): it
ray-traces procedural 3-view scenes on the device
(``data/shards.write_synthetic_dataset``) or, with ``--cubes``, the online
generator's samples with their six cube faces per view
(``OnlineImageGenerator.write_shards``, the split's seeds), and writes
them 64 to a shard in the format both packages read.  The training and
render CLIs take the directory through ``--shards``; ``render_cubes
--shards`` needs ``--cubes`` shards.  It runs on the CUDA device and raises
without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--num", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--m3d-dist", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=3,
                    help="--cubes only: views per sample")
    ap.add_argument("--cubes", action="store_true",
                    help="also render and store the 6 cube faces of every "
                         "view (rgb/depth/rots/trans_cubes) through the "
                         "online generator; render_cubes --shards reads "
                         "them")
    ap.add_argument("--split", default="train",
                    choices=["train", "val", "test"],
                    help="--cubes only: the online generator's split, "
                         "which seeds the scenes")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Run the tool on ``argv``; returns the number of samples written."""
    args = parse_args(argv)
    if args.cubes:
        from panogrf_tpu_torch.data.online import OnlineImageGenerator
        gen = OnlineImageGenerator(
            args.split, args.height, args.width, seq_len=args.seq_len,
            m3d_dist=args.m3d_dist, with_cubes=True, seed=args.seed,
            device=args.device)
        gen.write_shards(args.out, args.num)
    else:
        from panogrf_tpu_torch.data.shards import write_synthetic_dataset
        write_synthetic_dataset(args.out, args.num, args.height, args.width,
                                args.m3d_dist, args.seed,
                                device=args.device)
    print(f"wrote {args.num} samples to {args.out}")
    return args.num


if __name__ == "__main__":
    main()
