"""The serving artifact (``runtime/export.py``) against the JAX package's.

The JAX package's five export cases (``tests/test_export.py``): the byte
round trip and the magic, the manifest (here equal to JAX
``serving_manifest`` key for key), ``ONE_HOT_PC`` channels, the camera-only
arity and the CLI. Then the port's own: the exported graph holds one
``cfd3d.dcn_fwd*`` operator per DeformConv node, a fresh process loads the
artifact without importing the model code, the loaded program is bitwise
``Detector._forward`` on the CPU, and against JAX's jitted
``make_serving_fn`` on the same He-scaled weights (64x128, DeformConv
nodes, radar and frustum, K 8, B 2): in float64 (``jax.enable_x64``) every
output tensor within 1e-4 of its largest magnitude; in bf16 (``MIXED_PRECISION
True`` in both) each output's deviation from the float64 result at most
twice JAX bf16's plus 1e-3 of its largest magnitude, the rule of
``tests/test_torch_mixed_precision.py``. The ``cuda`` case holds an
artifact exported on the card against ``Detector._forward`` there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.runtime import export
from centerfusiondetect3d_tpu_torch.runtime.detector import Detector
from centerfusiondetect3d_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "MODEL.APPROX_TOPK", "False",
        "MODEL.DLA.DCN_IMPL", "'xla'", "MODEL.K", "8"]
FP32 = ["MIXED_PRECISION", "False"]
BATCH = 2
F64_RTOL = 1e-4  # of each output tensor's largest magnitude
HEAD_MULT, HEAD_ATOL = 2.0, 1e-3  # test_torch_mixed_precision.py's rule


def _tiny_cfg(extra=()):
    return load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)",
                             "MODEL.DLA.NODE", "Conv", "MODEL.K", "8",
                             *FP32, *extra], num_classes=10)


def _inputs(cfg, b=BATCH, seed=0, channels=3, radar=True):
    """(image, [pc_dep,] calib, trans_inv) numpy arrays of the contract."""
    rng = np.random.RandomState(seed)
    ih, iw = cfg.MODEL.INPUT_SIZE
    oh, ow = cfg.MODEL.OUTPUT_SIZE
    image = rng.randint(0, 256, (b, ih, iw, 3)).astype(np.uint8)
    calib = np.tile(np.array([[120.0, 0, ow / 2, 0], [0, 120.0, oh / 2, 0],
                              [0, 0, 1, 0]], np.float32)[None], (b, 1, 1))
    trans_inv = np.tile(np.array([[4.0, 0, 0.5], [0, 4.0, 0.25]],
                                 np.float32)[None], (b, 1, 1))
    out = [image]
    if radar:
        pc = np.abs(rng.randn(b, oh, ow, channels)).astype(np.float32) * 20
        pc[rng.rand(b, oh, ow) < 0.9] = 0.0  # sparse, as radar maps are
        out.append(pc)
    return tuple(out + [calib, trans_inv])


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _reference(det, inputs):
    """``Detector._forward`` on the artifact's inputs (the dense map NCHW)."""
    t = _torch(inputs)
    pc = t[1].permute(0, 3, 1, 2).contiguous() if len(t) == 4 else None
    with torch.inference_mode():
        out, _ = det._forward(t[0], pc, t[-2], t[-1])
    return out


def _dcn_targets(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "cfd3d" in str(n.target)]


# ------------------------------------------------------- the JAX cases


def test_manifest_equals_jax_serving_manifest():
    jax_export = pytest.importorskip("centerfusiondetect3d_tpu.runtime.export")
    jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
    for extra, b, platforms in (((), 4, None),
                                (("DATASET.ONE_HOT_PC", "True",
                                  "DATASET.MAX_PC_DIST", "10",
                                  "MODEL.FRUSTUM", "False",
                                  "TEST.FLIP_TEST", "True"), 2, ["cuda"]),
                                (("DATASET.RADAR_PC", "False"), 1, None)):
        opts = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.K", "8", *extra]
        cfg = load_config(opts=opts, num_classes=10)
        jcfg = jax_config.load_config(opts=opts, num_classes=10)
        got = export.serving_manifest(cfg, b, platforms)
        want = jax_export.serving_manifest(jcfg, b, platforms)
        assert list(got) == list(want)
        assert got == want
        assert json.loads(json.dumps(got)) == got
    with pytest.raises(ValueError, match="platforms"):
        export.serving_manifest(cfg, 1, ["tpu"])


def test_export_one_hot_radar_channels():
    cfg = _tiny_cfg(["MODEL.K", "4", "DATASET.ONE_HOT_PC", "True",
                     "DATASET.MAX_PC_DIST", "10", "MODEL.FRUSTUM", "False"])
    assert export.pc_dep_channels(cfg) == 30
    torch.manual_seed(0)
    det = Detector(cfg, device="cpu")
    fn, manifest = export.load_serving(
        export.export_serving(cfg, batch_size=1, device="cpu",
                              model=det.model), "cpu")
    assert manifest["pc_dep_channels"] == 30
    inputs = _inputs(cfg, 1, channels=30)
    out = fn(*_torch(inputs))
    assert out["scores"].shape == (1, 4)
    want = _reference(det, inputs)
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_export_camera_only():
    """RADAR_PC False: the program takes (image, calib, trans_inv)."""
    cfg = _tiny_cfg(["DATASET.RADAR_PC", "False", "MODEL.FRUSTUM", "False",
                     "MODEL.FUSION_STRATEGY", "''"])
    torch.manual_seed(1)
    det = Detector(cfg, device="cpu")
    fn, manifest = export.load_serving(
        export.export_serving(cfg, batch_size=1, device="cpu",
                              model=det.model), "cpu")
    assert manifest["radar_pc"] is False and manifest["pc_dep_channels"] == 0
    inputs = _inputs(cfg, 1, radar=False)
    assert len(inputs) == 3
    out = fn(*_torch(inputs))
    assert out["scores"].shape == (1, 8)
    want = _reference(det, inputs)
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_export_cli_writes_the_artifact_and_its_manifest(tmp_path):
    out = str(tmp_path / "artifact.cfd3")
    export.main(["--cfg", os.path.join(REPO, "configs",
                                       "centerfusion_debug.yaml"),
                 "--out", out, "--device", "cpu", "--batch-size", "2",
                 "--platforms", "cpu", "MODEL.INPUT_SIZE", "(64, 128)",
                 "MODEL.DLA.NODE", "Conv", "MODEL.K", "4", *FP32,
                 "MODEL.FRUSTUM", "False"])
    with open(out, "rb") as f:
        data = f.read()
    fn, manifest = export.load_serving(data, "cpu")
    assert manifest["k"] == 4 and manifest["batch_size"] == 2
    assert manifest["platforms"] == ["cpu"]
    with open(out + ".manifest.json") as f:
        assert json.load(f) == manifest
    cfg = _tiny_cfg(["MODEL.K", "4"])
    assert fn(*_torch(_inputs(cfg, 2)))["scores"].shape == (2, 4)


# ---------------------------------------- DeformConv artifacts vs JAX


@pytest.fixture(scope="module")
def pair():
    """The He-scaled JAX weights of OPTS, the port state_dict, the inputs
    and JAX's jitted make_serving_fn outputs in float64 and in bf16."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")
    jax_export = pytest.importorskip("centerfusiondetect3d_tpu.runtime.export")
    jax_detector = pytest.importorskip(
        "centerfusiondetect3d_tpu.runtime.detector")
    jax_models = pytest.importorskip("centerfusiondetect3d_tpu.models")
    from test_torch_detector import _perturb

    jcfg = jax_config.load_config(opts=OPTS + FP32, num_classes=10)
    jdet = jax_detector.Detector(jcfg, batch_size=BATCH)
    variables = _perturb(jdet.variables, 1)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"],
                             jcfg.head_conv)
    cfg = load_config(opts=OPTS + FP32, num_classes=10)
    inputs = _inputs(cfg)

    def run(config, v, f64):
        real = jax_detector.build_model
        if f64:  # the serving Detector builds its model in float64
            jax_detector.build_model = lambda c: jax_models.build_model(
                c, dtype=jnp.float64)
        try:
            with jax.enable_x64(f64):
                vv = jax.tree.map(lambda a: jnp.asarray(
                    a, jnp.float64 if f64 else jnp.float32), v)
                fn = jax.jit(jax_export.make_serving_fn(config, vv))
                out = fn(*(jnp.asarray(a) for a in inputs))
                return {k: np.asarray(o, np.float64) for k, o in out.items()}
        finally:
            jax_detector.build_model = real

    jcfg16 = jax_config.load_config(opts=OPTS + ["MIXED_PRECISION", "True"],
                                    num_classes=10)
    return {"sd": sd, "inputs": inputs, "f64": run(jcfg, variables, True),
            "bf16": run(jcfg16, variables, False)}


def _float64_detector(sd):
    from test_torch_detector_files import float64_model

    cfg = load_config(opts=OPTS + FP32, num_classes=10)
    model = float64_model(cfg)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in sd.items()})
    return cfg, Detector(cfg, device="cpu", model=model)


@pytest.fixture(scope="module")
def f64_artifact(pair):
    cfg, det = _float64_detector(pair["sd"])
    program = export.export_program(cfg, batch_size=BATCH, device="cpu",
                                    model=det.model)
    data = export.export_serving(cfg, batch_size=BATCH, device="cpu",
                                 model=det.model)
    return cfg, det, program, data


def test_graph_holds_one_operator_per_deformconv_node(f64_artifact):
    cfg, det, program, _ = f64_artifact
    nodes = sum(isinstance(m, DeformConvNode) for m in det.model.modules())
    assert nodes == 16
    assert _dcn_targets(program) == ["cfd3d.dcn_fwd.default"] * nodes
    cfg16 = load_config(opts=OPTS + ["MIXED_PRECISION", "True"],
                        num_classes=10)
    program16 = export.export_program(cfg16, batch_size=1, device="cpu")
    assert _dcn_targets(program16) == ["cfd3d.dcn_fwd_bf16.default"] * nodes


def test_roundtrip_magic_and_a_process_without_the_model_code(
        f64_artifact, tmp_path):
    cfg, det, _, data = f64_artifact
    assert isinstance(data, bytes) and data[:8] == export._MAGIC
    manifest, _ = export.read_artifact(data)
    assert manifest == export.serving_manifest(cfg, BATCH)
    with pytest.raises(ValueError, match="magic"):
        export.load_serving(data[8:], "cpu")
    path = tmp_path / "a.cfd3"
    path.write_bytes(data)
    inputs = _inputs(cfg, seed=3)
    np.savez(tmp_path / "inputs.npz", *inputs)
    code = f"""
import sys, numpy as np, torch
torch.set_num_threads(2)  # this process's: the reductions' order follows it
from centerfusiondetect3d_tpu_torch.runtime.export import load_serving
fn, manifest = load_serving(open({str(path)!r}, 'rb').read(), 'cpu')
z = np.load({str(tmp_path / 'inputs.npz')!r})
out = fn(*(torch.from_numpy(z[f'arr_{{i}}']) for i in range(len(z.files))))
torch.save(out, {str(tmp_path / 'out.pt')!r})
mods = sorted(m for m in sys.modules if m.startswith('centerfusiondetect3d'))
print('MODULES=' + ','.join(mods))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = [l for l in proc.stdout.splitlines() if l.startswith("MODULES=")]
    mods = mods[0].split("=", 1)[1].split(",")
    assert "centerfusiondetect3d_tpu_torch.runtime.export" in mods
    assert not [m for m in mods if m.startswith((
        "centerfusiondetect3d_tpu_torch.models",
        "centerfusiondetect3d_tpu_torch.config",
        "centerfusiondetect3d_tpu_torch.runtime.detector",
        "centerfusiondetect3d_tpu."))], mods
    got = torch.load(tmp_path / "out.pt")
    want = _reference(det, inputs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_float64_artifact_matches_jax_make_serving_fn(pair, f64_artifact):
    cfg, det, _, data = f64_artifact
    fn, _ = export.load_serving(data, "cpu")
    out = fn(*_torch(pair["inputs"]))
    want = _reference(det, pair["inputs"])
    assert all(torch.equal(out[k], want[k]) for k in want)
    ref = pair["f64"]
    assert sorted(out) == sorted(ref)
    for k, r in ref.items():
        got = out[k].double().numpy()
        assert got.shape == r.shape, k
        scale = max(np.abs(r).max(), 1e-30)
        assert np.abs(got - r).max() <= F64_RTOL * scale, (
            k, np.abs(got - r).max() / scale)


def _paired_rows(outs, ref):
    """Per image, the rows of ``ref`` whose detection (class, centre within
    0.5 px of the output plane) every run of ``outs`` holds, with each
    run's row: bf16 noise may reorder near-equal peaks, and a quantity is
    compared on the same detection."""
    pairs = []
    for b in range(ref["scores"].shape[0]):
        for i in range(ref["scores"].shape[1]):
            rows = []
            for out in outs:
                same = np.flatnonzero(out["classIds"][b] == ref["classIds"][b, i])
                d = (np.abs(out["centers"][b, same] - ref["centers"][b, i])
                     .max(-1) if len(same) else np.array([]))
                if not len(same) or d.min() >= 0.5:
                    break
                rows.append(int(same[np.argmin(d)]))
            else:
                pairs.append((b, i, rows))
    return pairs


def test_bf16_artifact_matches_jax_mixed_precision(pair):
    """The bf16 artifact is bitwise the port's bf16 ``Detector._forward``,
    and its outputs are off the float64 result by at most twice JAX bf16's
    deviation plus 1e-3 of the largest magnitude: the sorted top-K scores
    (a continuous function of the heatmap) always, every other quantity on
    the detections that both bf16 runs share with float64. The seeded net's
    heatmaps are flat, so bf16 rounding reorders their near-equal peaks in
    both packages and few detections are shared; the heads themselves are
    held against JAX bf16 by ``test_torch_mixed_precision.py``."""
    cfg16 = load_config(opts=OPTS + ["MIXED_PRECISION", "True"],
                        num_classes=10)
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in pair["sd"].items()}
    det = Detector(cfg16, sd, device="cpu")
    fn, _ = export.load_serving(
        export.export_serving(cfg16, batch_size=BATCH, device="cpu",
                              model=det.model), "cpu")
    got = fn(*_torch(pair["inputs"]))
    want = _reference(det, pair["inputs"])
    assert all(torch.equal(got[k], want[k]) for k in want)
    port = {k: v.double().numpy() for k, v in got.items()}
    ref, jax16 = pair["f64"], pair["bf16"]
    rows = _paired_rows([port, jax16], ref)
    worst = {}
    for k in ref:
        if k == "scores":
            r, p, j = ref[k], port[k], jax16[k]
        elif rows:
            r = np.stack([ref[k][b, i] for b, i, _ in rows])
            p = np.stack([port[k][b, n[0]] for b, _, n in rows])
            j = np.stack([jax16[k][b, n[1]] for b, _, n in rows])
        else:
            continue
        scale = max(np.abs(r).max(), 1e-30)
        dev_port = np.abs(p - r).max() / scale
        dev_jax = np.abs(j - r).max() / scale
        worst[k] = (dev_port, dev_jax)
        assert dev_port <= HEAD_MULT * dev_jax + HEAD_ATOL, (k, dev_port,
                                                             dev_jax)
    print(f"bf16 artifact: {len(rows)} of {ref['scores'].size} detections "
          "shared; (port, JAX) deviation from float64: " + ", ".join(
              f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in worst.items()))
    # bf16 is in use: the scores are off float64 by more than float32 noise
    assert worst["scores"][0] > 1e-5, worst


# ------------------------------------------------------------ the card


@pytest.mark.cuda
def test_artifact_on_card_matches_detector_forward():
    """A bf16 artifact exported on the card, loaded there, against
    ``Detector._forward`` on the same device tensors: 16 ``dcn_fwd_bf16``
    launches a call and outputs within bf16 noise (bitwise expected)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from centerfusiondetect3d_tpu_torch.ops import dcn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(opts=OPTS + ["MIXED_PRECISION", "True"],
                      num_classes=10)
    torch.manual_seed(0)
    det = Detector(cfg)
    fn, _ = export.load_serving(export.export_serving(
        cfg, batch_size=BATCH, model=det.model))
    inputs = tuple(t.cuda() for t in _torch(_inputs(cfg, seed=4)))
    before = (dcn.dcn_fwd_bf16.launches, dcn.deform_conv2d.launches)
    out = fn(*inputs)
    torch.cuda.synchronize()
    assert (dcn.dcn_fwd_bf16.launches - before[0],
            dcn.deform_conv2d.launches - before[1]) == (16, 0)
    pc = inputs[1].permute(0, 3, 1, 2).contiguous()
    with torch.inference_mode():
        want, _ = det._forward(inputs[0], pc, inputs[2], inputs[3])
    for k, w in want.items():
        scale = max(w.abs().max().item(), 1e-30)
        assert (out[k] - w).abs().max().item() <= 8e-3 * scale, k
