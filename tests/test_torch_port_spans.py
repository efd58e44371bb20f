"""The port's spans (``panogrf_tpu_torch/utils/spans.py``) on the CPU.

Off (no profiler recording), ``span`` is one shared null context and
touches neither ``record_function`` nor CUDA events, and the store stays
empty.  On, under ``torch.profiler``, a 64x128 walkthrough pass of the
serving preset at a coarse factor of 2, a depth-stack forward and one MVS
training step on its frozen prior enter every span where the work
happens: each appears in the exported trace, nested as documented, as
often as the chunk counts say, and the frames, depths, loss and updated
weights are bit-identical to the same calls with the profiler off.
"""

import copy
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.models.depth_stack import DepthStack
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.models.unifuse import UniFuse, normalize_imagenet
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.presets import preset_kwargs
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.utils import spans
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN = 64, 128, 32, 64, 16
CHUNK, COARSE_LOWRES, FRAMES = 1024, 2, 2
MVS_KW = {"num_hypotheses": 8, "magnet_num_samples": 3, "cnn3d_base": 8}

# each span's documented parents (None: no enclosing span); the trainer's
# forward runs the MVS net's sweep and regularisation
PARENTS = {
    "panogrf.prepare_ref": {None},
    "panogrf.render.coarse": {None},
    "panogrf.render.gather": {None, "panogrf.render.coarse"},
    "panogrf.render.agg": {None, "panogrf.render.coarse"},
    "panogrf.agg.pool": {"panogrf.render.agg"},
    "panogrf.agg.attn": {"panogrf.render.agg"},
    "panogrf.stack": {None},
    "panogrf.mono": {None, "panogrf.stack"},
    "panogrf.mvs.sweep": {"panogrf.stack", "panogrf.train.forward"},
    "panogrf.mvs.reg": {"panogrf.stack", "panogrf.train.forward"},
    "panogrf.train.forward": {None},
    "panogrf.train.backward": {None},
    "panogrf.train.update": {None},
}


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    init_parameters_(module, torch.Generator().manual_seed(seed))
    return module


def chunk_counts(h: int, w: int, chunk: int, f: int,
                 coarse_chunk: int = 0) -> tuple:
    """(coarse, fine) chunks of one pass of ``_render_poses``: the fine
    pass splits the h x w rays into ``chunk``-ray chunks, the coarse pass
    the (h/f) x (w/f) low-res rays into chunks of ``coarse_chunk`` (0:
    ``chunk``) or all of them if fewer."""
    low = (h // f) * (w // f)
    return low // min(coarse_chunk or chunk, low), h * w // chunk


def test_chunk_rule_gives_the_walkthrough_pass():
    """At the benchmark's 512x1024 frame, 4096-ray chunks and a coarse
    factor of 2, a pass has 32 coarse and 128 fine chunks."""
    assert chunk_counts(512, 1024, 4096, 2) == (32, 128)


@pytest.fixture(scope="module")
def work():
    """Each measured path as a function of no arguments that returns its
    outputs: ``walk`` (prepare_ref_data, then one render_video_device
    pass of FRAMES poses), ``stack`` (a DepthStack forward) and ``train``
    (the frozen prior, then one DepthTrainer step on a fresh copy of the
    same net and optimizer state)."""
    g = torch.Generator().manual_seed(3)
    imgs = torch.rand(2, H, W, 3, generator=g)
    src = torch.rand(2, H, W, 3, generator=g)
    w2c = torch.zeros(2, 3, 4)
    w2c[:, :, :3] = torch.eye(3)
    w2c[0, :, 3] = torch.tensor([0.2, -0.1, 0.3])
    w2c[1, :, 3] = torch.tensor([-0.2, 0.1, -0.3])
    src_w2c = w2c.flip(0).clone()

    renderer = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
        fine_depth_sample_num=DN,
        **preset_kwargs("serving", compute_dtype="float32"), device="cpu",
        generator=torch.Generator().manual_seed(0)).eval()
    c2ws = torch.zeros(FRAMES, 3, 4)
    c2ws[:, :, :3] = torch.eye(3)
    c2ws[:, :, 3] = torch.linspace(-0.1, 0.1, FRAMES)[:, None]
    qdr = torch.tensor([[0.5, 15.0]])
    mvs_depth = 1.0 + 4.0 * torch.rand(2, DH, DW, 1, generator=g)

    def walk():
        ref = full_render.prepare_ref_data(
            renderer, {"imgs": imgs, "mvs_depth": mvs_depth, "w2c": w2c},
            device="cpu")
        return full_render.render_video_device(
            renderer, ref, c2ws, qdr, qdr.expand(2, 2), chunk=CHUNK,
            coarse_lowres=COARSE_LOWRES, device="cpu")

    mvs = seeded(MVSDepthModel(**MVS_KW), 31)
    with torch.no_grad():
        mvs.decoders2[2].conv2.bias.fill_(3.0)
    stack = DepthStack(seeded(UniFuse(), 30), mvs, (H, W), (DH, DW))

    def depth():
        return stack(imgs, src, w2c, src_w2c)

    prior = seeded(UniFuse(), 32).eval().requires_grad_(False)
    net = seeded(MVSDepthModel(**MVS_KW), 33)
    batch = {"panos": torch.rand(1, 2, H, W, 3, generator=g),
             "rots": torch.eye(3).expand(1, 2, 3, 3).clone(),
             "trans": torch.tensor([[[-0.2, 0.0, 0.6], [0.0, 0.0, 0.0]]]),
             "gt_depth": 0.3 + 8.0 * torch.rand(1, H, W, 1, generator=g)}

    def train():
        with torch.inference_mode():
            equi = normalize_imagenet(batch["panos"][:, 1])
            out = prior(equi, cubemap.equi_to_cube(equi, H // 2))
        model = copy.deepcopy(net)

        def forward_fn(b):
            out = model(b["panos"], b["rots"], b["trans"], b["mono_depth"],
                        b["mono_feat"])
            out["pred_depth"] = out.pop("depth")
            return out
        trainer = DepthTrainer(model, forward_fn, DepthTrainConfig(
            loss_type="l1_sphere", aux_d1_weight=0.5, clip_grad_value=1.0))
        loss = trainer.train_step({**batch,
                                   "mono_depth": out["pred_depth"].clone(),
                                   "mono_feat": out["mono_feat"].clone()})
        return {"loss": loss,
                **{k: p.detach() for k, p in model.named_parameters()}}

    return {"walk": walk, "stack": depth, "train": train}


def _flat(out) -> dict:
    if torch.is_tensor(out):
        return {"": out}
    return {k: v for k, v in out.items() if torch.is_tensor(v)}


@pytest.fixture(scope="module")
def traced(work, tmp_path_factory):
    """Every path run with the profiler off, then once more under
    ``torch.profiler`` (CPU activity): the outputs of both, the store's
    entries and summary, and the exported trace's ``panogrf.*`` ranges."""
    off = {k: _flat(fn()) for k, fn in work.items()}
    spans.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = {k: _flat(fn()) for k, fn in work.items()}
    store, summary, ms = list(spans._store), spans.summary(), \
        spans.device_ms()
    spans.reset()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e["name"].startswith("panogrf.")]
    return {"off": off, "on": on, "store": store, "summary": summary,
            "ms": ms, "events": events}


def test_off_is_the_shared_null_context(work, monkeypatch):
    """With no profiler recording, every path runs through its spans
    without creating a ``record_function`` or a CUDA event, and stores
    nothing."""
    def boom(*a, **k):
        raise AssertionError("a span called the profiler or CUDA while off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    spans.reset()
    assert spans.span("stack") is spans.span("render.agg") is spans._OFF
    with spans.span("stack"):
        pass
    for fn in work.values():
        fn()
    assert spans._store == [] and spans.device_ms() == {}
    assert spans.summary() == []


def test_every_span_appears_nested_as_documented(traced):
    names = {e["name"] for e in traced["events"]}
    assert names == set(PARENTS)
    for name, parent, *_ in traced["store"]:
        assert parent in PARENTS[name], (name, parent)
    # in the trace, each range lies inside one range of a documented
    # parent on its thread wherever the store gives it a parent
    ev = traced["events"]
    for name, allowed in PARENTS.items():
        mine = [e for e in ev if e["name"] == name]
        assert len(mine) == sum(1 for n, *_ in traced["store"] if n == name)
        if None in allowed:
            continue
        for c in mine:
            assert any(p["name"] in allowed and p["tid"] == c["tid"]
                       and p["ts"] <= c["ts"]
                       and c["ts"] + c["dur"] <= p["ts"] + p["dur"]
                       for p in ev), (name, c["ts"])


def test_call_counts_are_the_chunk_counts(traced):
    """A pass enters the coarse span once; each coarse and fine chunk
    enters the gather, the aggregation and its pool and attention once; a
    scene enters
    prepare_ref and the stack once; the stack and the prior each run
    UniFuse once, and the stack and the training step the MVS net's
    sweep and regularisation once."""
    coarse, fine = chunk_counts(H, W, CHUNK, COARSE_LOWRES)
    assert (coarse, fine) == (2, 8)
    calls = {r["name"]: r["calls"] for r in traced["summary"]}
    assert calls == {
        "panogrf.prepare_ref": 1, "panogrf.render.coarse": 1,
        "panogrf.render.gather": coarse + fine,
        "panogrf.render.agg": coarse + fine,
        "panogrf.agg.pool": coarse + fine,
        "panogrf.agg.attn": coarse + fine,
        "panogrf.stack": 1, "panogrf.mono": 2, "panogrf.mvs.sweep": 2,
        "panogrf.mvs.reg": 2, "panogrf.train.forward": 1,
        "panogrf.train.backward": 1, "panogrf.train.update": 1}
    under_coarse = [n for n, p, *_ in traced["store"]
                    if p == "panogrf.render.coarse"]
    assert under_coarse.count("panogrf.render.agg") == coarse


def test_children_fit_inside_their_parents(traced):
    """A span's self time is its time less its direct children's, never
    negative; the stack's children add up to no more than the stack."""
    ms, seen, children = traced["ms"], {}, {}
    for name, parent, *_ in traced["store"]:
        i = seen[name] = seen.get(name, -1) + 1
        if parent is not None:
            children[parent] = children.get(parent, 0.0) + ms[name][i]
    for r in traced["summary"]:
        assert r["ms"] == pytest.approx(sum(ms[r["name"]]))
        assert r["self_ms"] == pytest.approx(
            r["ms"] - children.get(r["name"], 0.0))
        assert 0.0 <= r["self_ms"] <= r["ms"]
    stack = ms["panogrf.stack"][0]
    assert 0.0 < children["panogrf.stack"] <= stack


def test_outputs_are_bit_identical_with_the_profiler_on(traced):
    for path, off in traced["off"].items():
        on = traced["on"][path]
        assert off.keys() == on.keys()
        for k, v in off.items():
            assert torch.equal(v, on[k]), (path, k)
    frames = traced["on"]["walk"][""]
    assert frames.shape == (FRAMES, H, W, 3)
    assert float((frames[0] - frames[1]).abs().max()) > 1e-3
    assert float(traced["on"]["stack"]["mvs_depth"].std()) > 0.0
    assert bool(torch.isfinite(traced["on"]["train"]["loss"]))
