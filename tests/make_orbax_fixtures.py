"""Write the orbax checkpoints the port's reader is held to.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixtures.py

Needs JAX, flax, optax and orbax (the JAX package's environment).  It
writes two checkpoint directories under ``tests/data/orbax/`` and, beside
each, ``<name>.expected.json``: the key path, shape, dtype and SHA-256 of
every leaf, read back through ``ocp.StandardCheckpointer().restore``.
Orbax's sidecar files ``_sharding`` and ``array_metadatas/`` (the
devices' layout, which neither orbax's restore without a target nor the
port's reader needs) are left out, so that the two fit in 1 MB: the
renderer's take 366 KB, its ``_METADATA`` another 541 KB.

* ``renderer``: the JAX ``Trainer.save`` layout (``{"state": TrainState,
  "best_metric"}`` with Adam's state) of a ``NeuralRayGenRenderer`` with
  the port render CLI's parameters.  Every float leaf cycles through 7
  small values (a prime period, so zstd codes it as matches), offset per
  leaf; every integer leaf is 7.  ``python -m
  panogrf_tpu_torch.tools.render --ckpt tests/data/orbax/renderer`` loads
  it and renders a finite frame.
* ``arrays``: Gaussian float32 over four 128 KB zstd blocks and a bit
  (4-stream Huffman literals, treeless blocks, ~11000 sequences a block),
  rounded to 6 mantissa bits so that its low 17 bits are zeros (under
  half the size), zeros, an int32 step and a float32 scalar.

A leaf's path in ``expected.json`` is its keys joined by "/" (an integer
key indexes a list).  The two checkpoints and their ``expected.json`` stay
under 1,000,000 bytes; orbax's commits vary the renderer's by some 20 KB
from run to run, and the script raises when the sum is over.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "orbax"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]


def _pattern(tree):
    """Float leaves: 0.01 * (((3 * j + leaf) % 7) - 3); integer leaves 7."""
    import jax
    import jax.numpy as jnp
    leaves, treedef = jax.tree.flatten(tree)
    out = []
    for i, leaf in enumerate(leaves):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating):
            j = np.arange(a.size, dtype=np.int64).reshape(a.shape)
            v = 0.01 * (((3 * j + i) % 7) - 3)
            out.append(jnp.asarray(v, a.dtype))
        else:
            out.append(jnp.full(a.shape, 7, a.dtype))
    return jax.tree.unflatten(treedef, out)


def _expected(path: Path) -> list:
    """Every leaf of the checkpoint as orbax restores it."""
    import jax
    import orbax.checkpoint as ocp
    tree = ocp.StandardCheckpointer().restore(path.absolute())
    rows = []
    for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.array(leaf, order="C")
        route = "/".join(str(k.idx) if isinstance(
            k, jax.tree_util.SequenceKey) else k.key for k in keys)
        dtype = "bfloat16" if a.dtype.name == "bfloat16" else a.dtype.str
        rows.append([route, list(a.shape), dtype,
                     hashlib.sha256(a.tobytes()).hexdigest()])
    return rows


def renderer_checkpoint(dest: Path) -> None:
    from panogrf_tpu.train.trainer import Trainer, TrainerConfig
    from torch_port_parity import seeded_renderer_params
    variables = seeded_renderer_params(0, height=32, width=64,
                                       depth_hw=(32, 64))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainerConfig(name="fixture", save_dir=tmp)
        tr = Trainer(lambda p, b, r: None, _pattern(variables), cfg)
        tr.state = tr.state.replace(step=tr.state.step + 7,
                                    opt_state=_pattern(tr.state.opt_state))
        tr.best_metric = 21.5
        tr.save("latest")
        shutil.move(str(Path(tmp) / "fixture" / "latest"), str(dest))


def arrays_checkpoint(dest: Path) -> None:
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    rng = np.random.default_rng(13)
    gauss = rng.standard_normal(4 * 32768 + 1000).astype(np.float32)
    gauss = (gauss.view(np.uint32) & np.uint32(0xFFFE0000)).view(np.float32)
    tree = {"gauss": jnp.asarray(gauss),
            "zeros": jnp.zeros((64, 96), jnp.float32),
            "step": jnp.asarray(12345, jnp.int32),
            "scale": jnp.asarray(0.125, jnp.float32)}
    ck = ocp.StandardCheckpointer()
    ck.save(dest.absolute(), tree)
    ck.wait_until_finished()


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    total = 0
    for name, make in (("renderer", renderer_checkpoint),
                       ("arrays", arrays_checkpoint)):
        dest = OUT / name
        shutil.rmtree(dest, ignore_errors=True)
        make(dest)
        (dest / "_sharding").unlink()
        shutil.rmtree(dest / "array_metadatas")
        rows = _expected(dest)
        (OUT / f"{name}.expected.json").write_text(
            "[\n" + ",\n".join(json.dumps(r, separators=(",", ":"))
                               for r in rows) + "\n]\n")
        size = sum(p.stat().st_size for p in dest.rglob("*") if p.is_file())
        total += size + (OUT / f"{name}.expected.json").stat().st_size
        print(f"{dest.relative_to(ROOT)}: {len(rows)} leaves, {size} bytes")
    if total > 1_000_000:
        raise SystemExit(f"fixtures take {total} bytes, over 1,000,000: "
                         "run again")
    print(f"fixtures: {total} bytes")


if __name__ == "__main__":
    main()
