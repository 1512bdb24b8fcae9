"""The port's run observability (``utils/observability.py``) against the JAX
package's.

- ``DeviceHealthMonitor``: JAX's tolerance and recovery cases
  (``tests/test_observability.py``) with ``torch.cuda``'s memory readings
  stubbed; a no-op on the CPU.
- ``estimate_cost``: on a small DLA-34 with DeformConv nodes, exactly the
  count worked out from each counted op's weight and the input and output
  shapes it met (conv arithmetic checked on them); its flops equal
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the same forward
  (the plain DCN's contraction is one matmul per tap on the CPU). JAX's
  ``estimate_cost`` (XLA's cost analysis) of the same configuration is
  printed beside it (``pytest -s``), with the ratio.
- ``plot_lr_schedule``'s list and ``plot_history``'s ``history.json`` equal
  JAX's; ``create_logger``'s run directory and log file.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.config import load_config
from centerfusiondetect3d_tpu_torch.models import build_model
from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode
from centerfusiondetect3d_tpu_torch.utils import observability as obs

jax = pytest.importorskip("jax")
jax_obs = pytest.importorskip("centerfusiondetect3d_tpu.utils.observability")
jax_load_config = pytest.importorskip(
    "centerfusiondetect3d_tpu.config").load_config
jax_build_model = pytest.importorskip(
    "centerfusiondetect3d_tpu.models").build_model

torch.set_num_threads(2)

OPTS = ["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
        "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", "True",
        "MODEL.FUSION_STRATEGY", "'middle'", "MIXED_PRECISION", "False"]
B = 2


class _Props:
    total_memory = 100


def _stub_cuda(monkeypatch, used):
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: used[0])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: _Props())


def test_health_monitor_tolerance(monkeypatch):
    used = [90]
    _stub_cuda(monkeypatch, used)
    mon = obs.DeviceHealthMonitor(hbm_fraction_limit=0.5, tolerance=2,
                                  logger=logging.getLogger("t"),
                                  device="cuda:0")
    mon.check()  # the first reading over the limit warns only
    with pytest.raises(RuntimeError, match="consecutive"):
        mon.check()


def test_health_monitor_recovers(monkeypatch):
    used = [90]
    _stub_cuda(monkeypatch, used)
    mon = obs.DeviceHealthMonitor(hbm_fraction_limit=0.5, tolerance=2,
                                  device="cuda:0")
    mon.check()
    used[0] = 10  # the pressure clears: the count starts again
    mon.check()
    used[0] = 90
    mon.check()  # 1 of 2 again: must not raise


def test_health_monitor_is_a_noop_on_the_cpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read the card's memory on the CPU")

    monkeypatch.setattr(torch.cuda, "memory_allocated", boom)
    mon = obs.DeviceHealthMonitor(hbm_fraction_limit=0.0, tolerance=1)
    for _ in range(3):
        mon.check()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, 3, 64, 128).astype(np.float32)
    pc_dep = np.abs(rng.randn(B, 3, 16, 32)).astype(np.float32)
    calib = np.tile(np.array([[[400.0, 0, 64, 0], [0, 400, 32, 0],
                               [0, 0, 1, 0]]], np.float32), (B, 1, 1))
    return img, pc_dep, calib


def _analytic_cost(model, args):
    """Flops and bytes from the shapes each counted op met, worked out with
    the conv arithmetic written out."""
    seen = []
    kinds = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear,
             DeformConvNode)
    handles = [m.register_forward_hook(
        lambda m, a, out: seen.append((m, tuple(a[0].shape),
                                       tuple(out.shape))))
        for m in model.modules() if isinstance(m, kinds)]
    model.eval()
    with torch.no_grad():
        model(*args)
    for h in handles:
        h.remove()
    flops = nbytes = 0
    n_dcn = 0
    for m, (n, cin, hin, win), (n2, cout, hout, wout) in seen:
        assert n == n2 == B
        pbytes = 4 * (m.weight.numel() + (0 if m.bias is None
                                          else m.bias.numel()))
        io = 4 * (n * cin * hin * win + n * cout * hout * wout)
        if isinstance(m, DeformConvNode):
            n_dcn += 1
            assert (hout, wout) == (hin, win)
            flops += 2 * n * hout * wout * 9 * cin * cout
            nbytes += io + pbytes + 4 * n * 27 * hin * win
            continue
        kh, kw = m.kernel_size
        (sh, sw), (ph, pw), (dh, dw) = m.stride, m.padding, m.dilation
        if isinstance(m, torch.nn.ConvTranspose2d):
            assert hout == (hin - 1) * sh - 2 * ph + dh * (kh - 1) + 1
            assert wout == (win - 1) * sw - 2 * pw + dw * (kw - 1) + 1
            flops += 2 * n * hin * win * cin * (cout // m.groups) * kh * kw
        else:
            assert hout == (hin + 2 * ph - dh * (kh - 1) - 1) // sh + 1
            assert wout == (win + 2 * pw - dw * (kw - 1) - 1) // sw + 1
            flops += 2 * n * hout * wout * cout * (cin // m.groups) * kh * kw
        nbytes += io + pbytes
    return flops, nbytes, n_dcn


@pytest.fixture(scope="module")
def port_model():
    cfg = load_config(opts=OPTS, num_classes=10)
    torch.manual_seed(0)
    return cfg, build_model(cfg)


def test_estimate_cost_is_the_analytic_count(port_model):
    cfg, model = port_model
    args = [torch.from_numpy(a) for a in _inputs()]
    model.train()
    cost = obs.estimate_cost(model, *args)
    assert model.training  # the mode is restored
    flops, nbytes, n_dcn = _analytic_cost(model, args)
    assert n_dcn == 16
    assert cost == {"flops": float(flops), "bytes_accessed": float(nbytes)}
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(*args)
    assert counter.get_total_flops() == flops


def test_estimate_cost_beside_jax_xla(port_model):
    """JAX's figure is XLA's cost analysis of the whole fused program: it
    counts BatchNorm, activations and the DCN's sampling too, and the
    bytes of fused programs; printed, not held to the port's count."""
    cfg, model = port_model
    img, pc_dep, calib = _inputs()
    cost = obs.estimate_cost(model, *(torch.from_numpy(a)
                                      for a in (img, pc_dep, calib)))
    jcfg = jax_load_config(opts=OPTS, num_classes=10)
    jmodel = jax_build_model(jcfg)
    img_nhwc = np.ascontiguousarray(img.transpose(0, 2, 3, 1))
    pc_nhwc = np.ascontiguousarray(pc_dep.transpose(0, 2, 3, 1))
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), img_nhwc, None, pc_nhwc, calib, train=False)

    def fwd(params, stats, image, pc_hm, pc_dep_, calib_):
        return jmodel.apply({"params": params, "batch_stats": stats}, image,
                            pc_hm, pc_dep_, calib_, train=False)

    jcost = jax_obs.estimate_cost(fwd, variables["params"],
                                  variables["batch_stats"], img_nhwc, None,
                                  pc_nhwc, calib)
    assert jcost["flops"] > 0 and cost["flops"] > 0
    print(f"\nDLA-34 DeformConv, {B}x64x128, float32: port estimate_cost "
          f"{cost['flops'] / 1e9:.4f} GFLOPs, "
          f"{cost['bytes_accessed'] / 2 ** 30:.4f} GiB; JAX XLA "
          f"{jcost['flops'] / 1e9:.4f} GFLOPs, "
          f"{jcost['bytes_accessed'] / 2 ** 30:.4f} GiB; ratio port / XLA "
          f"flops {cost['flops'] / jcost['flops']:.4f}, bytes "
          f"{cost['bytes_accessed'] / jcost['bytes_accessed']:.4f}")


def test_plot_lr_schedule_matches_jax(tmp_path):
    opts = ["TRAIN.EPOCHS", "12", "TRAIN.LR_STEP", "[5, 9]",
            "TRAIN.WARM_EPOCHS", "2"]
    got = obs.plot_lr_schedule(load_config(opts=opts, num_classes=10),
                               str(tmp_path / "port.png"), start_epoch=1)
    want = jax_obs.plot_lr_schedule(jax_load_config(opts=opts,
                                                    num_classes=10),
                                    str(tmp_path / "jax.png"), start_epoch=1)
    assert got == want and len(got) == 11
    assert (tmp_path / "port.png").exists()


def test_plot_history_matches_jax(tmp_path):
    history = {"train": {"total": [3.0, 2.5, 2.0], "hm": [1.0, 0.5, 0.25]},
               "val": {"total": [4.0, 3.0]}}
    for name, fn in (("port", obs.plot_history),
                     ("jax", jax_obs.plot_history)):
        os.makedirs(tmp_path / name)
        assert fn(history, str(tmp_path / name)) == str(
            tmp_path / name / "losses.png")
    for name in ("port", "jax"):
        assert (tmp_path / name / "losses.png").stat().st_size > 0
    with open(tmp_path / "port" / "history.json") as f, \
            open(tmp_path / "jax" / "history.json") as g:
        assert json.load(f) == json.load(g) == history
    assert obs.plot_history({"train": {}, "val": {}}, str(tmp_path)) is None


def test_plots_without_matplotlib(tmp_path, monkeypatch):
    import sys

    for name in list(sys.modules):
        if name.split(".")[0] == "matplotlib":
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert obs.plot_history({"train": {"total": [1.0]}}, str(tmp_path)) is None
    cfg = load_config(opts=["TRAIN.EPOCHS", "3"], num_classes=10)
    assert len(obs.plot_lr_schedule(cfg, str(tmp_path / "lr.png"))) == 3
    assert list(tmp_path.iterdir()) == []


def test_create_logger_run_directory(tmp_path):
    logger, out_dir = obs.create_logger(str(tmp_path), "unit")
    assert os.path.dirname(out_dir) == str(tmp_path / "unit")
    logger.info("hello")
    for handler in logger.handlers:
        handler.flush()
    with open(os.path.join(out_dir, "train.log")) as f:
        assert "hello" in f.read()
    assert not logger.propagate


def test_stage_timer_waits_for_its_own_stream_only(monkeypatch):
    """On a CUDA device ``StageTimer.stop`` waits for the calling thread's
    current stream, not the whole device: the Loader's decode streams and
    ``device_prefetch``'s copies are not the step's work."""
    waited = []

    class Stream:
        def synchronize(self):
            waited.append("stream")

    def device_wide(*args, **kwargs):
        raise AssertionError("StageTimer.stop synchronized the whole device")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: Stream())
    monkeypatch.setattr(torch.cuda, "synchronize", device_wide)
    timer = obs.StageTimer("cuda")
    timer.start("step")
    assert timer.stop("step") >= 0.0
    assert waited == ["stream"]
