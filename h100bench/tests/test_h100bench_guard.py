"""Nothing the harness loads is JAX or the JAX package, and the plain
reference loads nothing of the program."""

import subprocess
import sys

from h100bench import guard, manifest

ROOT = str(manifest.ROOT)


def loaded_by(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True,
                         check=True)
    return out.stdout.split()


def test_top_level_names_compared_whole():
    assert guard.foreign(["panogrf_tpu.models", "jax.numpy", "jaxtyping",
                          "panogrf_tpu_torch.nn", "flax", "optax_x"]) == \
        ["flax", "jax", "panogrf_tpu"]


def test_the_harness_loads_no_jax():
    mods = loaded_by(
        "import h100bench.run, h100bench.calibrate, h100bench.faults\n"
        "from h100bench import manifest\n"
        "for w in manifest.load_manifest()['workloads']:\n"
        "    c = manifest.Cell(w['name']); c.driver()\n"
        "    [manifest.reader(m['name']) for m in c.per_layer()]\n"
        "import panogrf_tpu_torch.renderer.full_render\n"
        "import panogrf_tpu_torch.train.depth_trainer\n"
        "import panogrf_tpu_torch.models.depth_stack")
    assert guard.foreign(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded_by(
        "import h100bench.reference.renderer.full_render\n"
        "import h100bench.reference.renderer.renderer\n"
        "import h100bench.reference.depth, h100bench.reference.train\n"
        "import h100bench.reference.precision")
    assert guard.foreign(mods) == []
    assert guard.foreign(mods, (guard.PROGRAM,)) == []
