"""The plain reference against the program's plain path at a tiny size on
the CPU (the program in float32 and float64: its CPU path is plain PyTorch
there, so the two agree to rounding)."""

import math

import numpy as np
import pytest
import torch

from cfbench_tiny import harness, tiny
from cfbench import weights
from cfbench.reference import inputs as rin
from cfbench.reference import loss as rloss
from cfbench.reference import postprocess as rpp
from cfbench.reference.model import build_reference


def _serving(name):
    wl = tiny(name, float32=True)
    run = harness.Run(wl, 7, 1.0, False, torch.device("cpu"), 0.0)
    drv = harness.load_module("traffic", wl["loop"])
    pool, ref, state = drv.make_inputs(run, torch.device("cpu"))
    return run, drv, pool, ref, state


@pytest.mark.parametrize("name", ["middle_serve_b24", "centernet_serve"])
def test_model_heads_equal_the_program_in_float64(name):
    from centerfusiondetect3d_tpu_torch.models.detector import build_model

    run, drv, pool, ref, state = _serving(name)
    frames, infos, clouds = pool.batch(0)
    x, pc, calib, _ = ref.inputs(frames, infos, clouds)
    prog = build_model(drv.program_config(run), dtype=torch.float64)
    prog.load_state_dict(state, strict=True)
    ref.model.double()
    with torch.no_grad():
        yp = prog.eval()(x.double(), None if pc is None else pc.double(),
                         calib.double())
        yr = ref.model(x.double(), None if pc is None else pc.double(),
                       calib.double(), frustum_from=yp)
    for h in list(ref.model.detectHead_0.first) + list(
            ref.model.detectHead_0.secondary):
        assert torch.allclose(yp[h], yr[h], rtol=1e-9, atol=1e-9), h


def test_inputs_equal_the_programs_pre_process():
    from centerfusiondetect3d_tpu_torch.runtime.detector import Detector
    from centerfusiondetect3d_tpu_torch.ops.rasterize import (
        paint_rects_device_batch)

    run, drv, pool, ref, state = _serving("middle_serve_b24")
    det = Detector(drv.program_config(run), device="cpu")
    frames, infos, clouds = pool.batch(1)
    batch, metas = det.pre_process(det.load_data(frames), infos, clouds)
    x, pc, calib, inv = ref.inputs(frames, infos, clouds)
    prog_x = (torch.from_numpy(batch["image"]).permute(0, 3, 1, 2).float()
              / 255.0 - det.mean) / det.std
    assert torch.equal(prog_x, x)
    prog_pc = paint_rects_device_batch(torch.from_numpy(batch["pc_boxes"]),
                                       torch.from_numpy(batch["pc_values"]),
                                       ref.out_hw)
    assert torch.equal(prog_pc, pc)
    assert torch.equal(torch.from_numpy(batch["calib"]), calib)


def test_decode_and_post_process_equal_the_programs():
    from centerfusiondetect3d_tpu_torch.ops.decode import fusion_decode
    from centerfusiondetect3d_tpu_torch.ops.postprocess import post_process

    run, drv, pool, ref, state = _serving("middle_serve_b24")
    frames, infos, clouds = pool.batch(0)
    x, pc, calib, inv = ref.inputs(frames, infos, clouds)
    with torch.no_grad():
        y = ref.model(x, pc, calib)
    prog = post_process(fusion_decode([y], ref.out_hw, k=ref.k), inv,
                        ref.out_hw, calib)
    det, _ = rpp.decode(y, ref.k)
    got = rpp.post_process(det, inv, ref.out_hw, calib)
    for key in ("scores", "classIds", "bboxes", "locations", "yaws",
                "dimension", "velocity", "nuscenes_att"):
        assert torch.allclose(prog[key], got[key], rtol=1e-6, atol=1e-5), key
    # the frustum association, box by box, against the program's masks
    from centerfusiondetect3d_tpu_torch.ops.frustum import (
        get_pc_frustum_heatmap)
    want = get_pc_frustum_heatmap(y, pc, calib, ref.k, ref.max_dist)
    assert torch.equal(rpp.frustum_heatmap(y, pc, calib, ref.k,
                                           ref.max_dist), want)


def test_loss_and_adamw_equal_the_programs():
    from centerfusiondetect3d_tpu_torch.losses.generic import GenericLoss

    wl = tiny("centernet_train_b64", float32=True)
    run = harness.Run(wl, 11, 1.0, False, torch.device("cpu"), 0.0)
    drv = harness.load_module("traffic", "train_step")
    batch = drv.make_batches(run, torch.device("cpu"))[0]
    model = build_reference(run.config)
    model.load_state_dict(weights.seeded_state(model, 3, "cpu"),
                          strict=False)
    model.train()
    y = model(batch["image"])
    w = {k: float(v) for k, v in run.config["model"]["loss_weights"].items()}
    got = rloss.loss(y, batch, w)
    total, parts = GenericLoss(drv.program_config(run))([y], batch)
    for k, v in got.items():
        assert float(v.detach()) == pytest.approx(float(parts[k].detach()),
                                                  rel=1e-6), k
    # AdamW: three steps against torch's
    p = {"a": torch.randn(5, 3, generator=torch.Generator().manual_seed(1))}
    q = torch.nn.Parameter(p["a"].clone())
    opt = torch.optim.AdamW([q], lr=1e-3, weight_decay=5e-4)
    mine = rloss.AdamW(1e-3, 5e-4)
    for t in range(3):
        g = torch.randn(5, 3, generator=torch.Generator().manual_seed(10 + t))
        q.grad = g.clone()
        opt.step()
        mine.step(p, {"a": g})
    assert torch.allclose(p["a"], q.detach(), rtol=1e-6, atol=1e-7)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for f in pathlib.Path(harness.BENCH_DIR, "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(
                node, ast.Import) else [node.module or ""] if isinstance(
                node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "centerfusiondetect3d_tpu", "centerfusiondetect3d_tpu_torch",
                    "jax", "jaxlib", "flax"), (f.name, n)
