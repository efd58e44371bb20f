"""The fused MLP kernels' variants, without a card: the variant choice
(``fused_mlp.choose_variant``), the C entry points of ``csrc/*.cu`` against
the ctypes declarations of ``_build._declare``, the arguments the wrapper
passes to a library that stands in for the built one, and the CUDA branch
of each variant's shapes, which reaches the kernel's loader first and never
the plain version."""

import re
import types

import numpy as np
import pytest
import torch

from panogrf_tpu_torch.ops.kernels import _build
from panogrf_tpu_torch.ops.kernels import fused_mlp as tmlp
from torch_port_threads import one_torch_thread  # noqa: F401

F32, BF16 = torch.float32, torch.bfloat16
PATH2, WIDE2 = (16, 16, 1), (35, 64, 32)
HEAD3, WIDE3 = (32, 32, 32, 2), (35, 64, 64, 32)
# (kernel, widths, dtype, x 16-byte aligned) -> the variant that must run
CASES = {("mlp2", PATH2, F32, True): "lanes",
         ("mlp2", PATH2, BF16, True): "lanes",
         ("mlp3", HEAD3, F32, True): "rows",
         ("mlp3", HEAD3, BF16, True): "mma"}


def _expected(name, dims, dtype, aligned):
    return CASES.get((name, dims, dtype, aligned), "generic")


def _x(n, din, dtype, aligned):
    """(n, din) x whose data lies 0 (aligned) or 1 element (misaligned)
    into a 64-byte-aligned buffer."""
    buf = torch.empty(n * din + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // buf.element_size()
    off = skip + (0 if aligned else 1)
    x = buf[off:off + n * din].view(n, din)
    x.copy_(torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, din)).astype(np.float32)).to(dtype))
    assert (x.data_ptr() % 16 == 0) == aligned
    return x


def _layers(dims, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [(torch.tensor(rng.normal(size=(a, b)) * a ** -0.5, dtype=dtype),
             torch.tensor(rng.normal(size=(b,)) * 0.1, dtype=dtype))
            for a, b in zip(dims[:-1], dims[1:])]


ALL = [(name, dims, dtype, aligned)
       for name, dims_list in (("mlp2", (PATH2, WIDE2)),
                               ("mlp3", (HEAD3, WIDE3)))
       for dims in dims_list for dtype in (F32, BF16)
       for aligned in (True, False)]


@pytest.mark.parametrize("name,dims,dtype,aligned", ALL)
def test_choose_variant(name, dims, dtype, aligned):
    """Specialised for the compiled widths and dtype with an aligned x,
    ``generic`` for other widths and for a misaligned x."""
    x = _x(4, dims[0], dtype, aligned)
    got = tmlp.choose_variant(name, dims, dtype, x.data_ptr())
    assert got == _expected(name, dims, dtype, aligned)


def _c_entry_points():
    """{name: ["pointer" | "int", ...]} of every ``extern "C" int
    panogrf_*(...)`` in ``csrc/*.cu``."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(panogrf_\w+)\s*\(([^)]*)\)',
                             text):
            params = [p.strip() for p in m.group(2).split(",")]
            kinds = []
            for p in params:
                if "*" in p:
                    kinds.append("pointer")
                elif re.fullmatch(r"int\s+\w+", p):
                    kinds.append("int")
                else:
                    raise AssertionError(f"{m.group(1)}: parameter {p!r}")
            found[m.group(1)] = kinds
    return found


class _StandIn:
    """Records the attributes ``_declare`` sets on each function."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        object.__setattr__(self, name, fn)
        return fn


def test_every_c_entry_point_is_declared():
    declared = _build._declare(_StandIn())
    entry = _c_entry_points()
    assert set(entry) == {"panogrf_mlp2", "panogrf_mlp3",
                          "panogrf_cross_view_pool", "panogrf_ray_attention"}
    assert set(entry) == {k for k in vars(declared) if k.startswith("panogrf_")}


@pytest.mark.parametrize("fn", ["panogrf_mlp2", "panogrf_mlp3",
                                "panogrf_cross_view_pool",
                                "panogrf_ray_attention"])
def test_c_entry_point_matches_ctypes_argtypes(fn):
    """The same number of arguments, ``c_void_p`` for each pointer (and the
    stream), ``c_int`` for each int, an int result."""
    import ctypes
    declared = getattr(_build._declare(_StandIn()), fn)
    kinds = _c_entry_points()[fn]
    want = [ctypes.c_void_p if k == "pointer" else ctypes.c_int for k in kinds]
    assert declared.argtypes == want
    assert declared.restype is ctypes.c_int


def test_build_log_is_kept_beside_the_library(tmp_path, monkeypatch):
    """nvcc's output (ptxas's registers and spills) is written beside the
    library it built and read back when a later process reuses that
    library, so a reused build still reports its kernels' registers."""
    import ctypes
    import subprocess
    log = "ptxas info    : Used 128 registers, 0 bytes spill stores\n"
    runs = []

    def nvcc(cmd, **kw):
        runs.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"library")
        return subprocess.CompletedProcess(cmd, 0, stdout=log, stderr="")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_declare", lambda lib: lib)
    for reused in (False, True):
        monkeypatch.setattr(_build, "_LIB", None)
        lib = _build.load_library()
        assert _build.BUILD_INFO["reused"] is reused
        assert _build.BUILD_INFO["log"] == log
        assert len(runs) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"{lib.rsplit('/', 1)[1][:-3]}.log", lib.rsplit("/", 1)[1]])


class _FakeLib:
    """Stands in for the built library: records each call, returns rc."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []
        _build._declare(self)

    def _call(self, name, *args):
        self.calls.append((name, args))
        return self.rc

    def __getattr__(self, name):
        if not name.startswith("panogrf_"):
            raise AttributeError(name)
        fn = lambda *a: self._call(name, *a)  # noqa: E731
        object.__setattr__(self, name, fn)
        return fn


@pytest.mark.parametrize("name,dims,dtype,aligned",
                         [c for c in ALL if c[1] in (PATH2, HEAD3)])
def test_launch_passes_variant_and_counts_it(monkeypatch, name, dims, dtype,
                                             aligned):
    """``_launch`` hands the library one argument per declared argtype, the
    chosen variant's id and the dtype's id, and counts the launch under its
    kernel and variant; a non-zero return raises and counts nothing."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(tmlp, "_stream", lambda x: 0)
    x = _x(17, dims[0], dtype, aligned)
    layers = _layers(dims, dtype)
    acts = ("elu",) * (len(dims) - 2) + ("relu",)
    variant = _expected(name, dims, dtype, aligned)
    tmlp.reset_launches()
    out = tmlp._launch(name, x, layers, acts)
    assert out.shape == (17, dims[-1]) and out.dtype == dtype
    (called, args), = lib.calls
    assert called == f"panogrf_{name}"
    n_ptr = 2 + 2 * len(layers)
    assert len(args) == n_ptr + 2 + len(layers) + len(acts) + 2 + 1
    ints = args[n_ptr:-1]
    assert ints[:2 + len(layers)] == (17, *dims)
    assert ints[-2:] == ({"generic": 0, "lanes": 1, "mma": 2, "rows": 3}[variant],
                         {F32: 0, BF16: 1}[dtype])
    assert args[0] == x.data_ptr()
    total = tmlp.MLP2_LAUNCHES if name == "mlp2" else tmlp.MLP3_LAUNCHES
    assert total == 1
    assert {k: v for k, v in tmlp.VARIANT_LAUNCHES.items() if v} \
        == {f"{name}_{variant}": 1}

    lib.rc = 1                                   # a failed launch raises
    with pytest.raises(RuntimeError, match=variant):
        tmlp._launch(name, x, layers, acts)
    assert sum(tmlp.VARIANT_LAUNCHES.values()) == 1
    tmlp.reset_launches()


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("name,dims,dtype,aligned", ALL)
def test_cuda_tensor_reaches_the_loader_first(monkeypatch, name, dims, dtype,
                                              aligned):
    """For every variant's shapes, a CUDA tensor goes to the kernel's
    loader before anything else that needs a card, and never to the plain
    version."""
    class _Loaded(Exception):
        pass

    def fail(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    def loader():
        raise _Loaded

    monkeypatch.setattr(tmlp, f"{name}_plain", fail)
    monkeypatch.setattr(tmlp, "_mlp_plain", fail)
    monkeypatch.setattr(_build, "load_library", loader)
    x = _x(33, dims[0], dtype, aligned)
    assert tmlp.choose_variant(name, dims, dtype, x.data_ptr()) \
        == _expected(name, dims, dtype, aligned)
    args = [torch.Tensor._make_subclass(_LooksCuda, t) for t in
            [x] + [t for wb in _layers(dims, dtype) for t in wb]]
    assert args[0].data_ptr() == x.data_ptr()
    acts = ("elu",) * (len(dims) - 2) + ("relu",)
    with pytest.raises(_Loaded):
        if name == "mlp2":
            tmlp.mlp2(*args, *acts)
        else:
            tmlp.mlp3(*args, acts)
