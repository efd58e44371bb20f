"""Convert a reference pre-rendered LMDB environment into shards.

    python -m panogrf_tpu_torch.tools.import_lmdb \\
        --env <dir>/lmdb_render_train_1024x512_seq_len_3_m3d_dist_0.5 \\
        --out data/shards/train_512 [--height 512 --width 1024 --seq-len 3] \\
        [--max-samples N] [--samples-per-shard 64]

Port of the repo's ``tools/import_lmdb.py``.  The geometry is parsed from
the environment's directory name (``lmdb_render_{mode}_{width}x{height}
_seq_len_{V}_m3d_dist_{d}``, the reference writer's scheme) unless the
flags give it.  The environment is read by the port's pure-Python LMDB
reader; the training and render CLIs then take the shard directory
through ``--shards``.  Host only: no device is used.
"""

from __future__ import annotations

import argparse

from panogrf_tpu_torch.data.lmdb_import import import_lmdb


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", required=True, help="LMDB env dir or data.mdb")
    ap.add_argument("--out", required=True, help="output shard dir")
    ap.add_argument("--height", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--seq-len", type=int)
    ap.add_argument("--max-samples", type=int)
    ap.add_argument("--samples-per-shard", type=int, default=64)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Run the tool on ``argv``; returns the number of samples imported."""
    args = parse_args(argv)
    n = import_lmdb(args.env, args.out, args.height, args.width,
                    args.seq_len, args.max_samples, args.samples_per_shard)
    print(f"imported {n} samples -> {args.out}")
    return n


if __name__ == "__main__":
    main()
