"""The multi-chip dry run: one training step over a (data, spatial, model)
layout, then the eval pass on the same layout held against one process.

    python -m centerfusiondetect3d_tpu_torch.tools.dryrun_multichip N
        [--device cpu]

The port of ``__graft_entry__.py:dryrun_multichip``. It starts N gloo
processes (``parallel.initialize`` over a ``file://`` store in a temporary
directory), on the CUDA card unless ``--device cpu`` is given (N ranks share
the one card), and lays them out as JAX does: ``n_spatial`` 2 where N is a
multiple of 8, ``n_model`` 2 where N is even and at least 4, the data axis
the rest. Each rank builds the flagship model at 64x128 with DeformConv
nodes and K=16 from seeded weights, JAX's batch (``numpy`` seed 0,
``max(N, 2)`` images, 8 objects each) and takes its data shard of it
through ``shard_batch``; it splits the wide head towers over the model axis
(``shard_params_tp``), takes one unfrozen training step under the layout
and needs a finite loss. Then the eval pass (forward, ``fusion_decode``,
``post_process``) on the same layout, the detections gathered over the
data axis, is held against one process running the whole batch on the
gathered weights: the heatmap and depth maps within rtol 1e-4 and atol
1e-5, the sorted scores likewise, and every detection key finite and of
the single process's shape. Rank 0 prints JAX's two lines; the exit code is
0 when every rank passed. Each rank has ``RANK_TIMEOUT`` seconds.

The model computes in float32 (``MIXED_PRECISION False``), where JAX's
config keeps its bf16 default: a bf16 rounding is two orders above the
comparison's rtol, and the layout sums in another order than one process.
``launch(n, "cpu", float64=True)`` (the CPU only: the DCN kernels take
float32 and bf16) runs model and batch in float64. A height-split layout
(N a multiple of 8) needs it at this tolerance: its halo convolutions and
DCN nodes sum in another order than the whole map's, and the seeded net
carries float32's rounding to 1.7e-4 of the depth map (8 CPU ranks; 1e-14
in float64).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
RANK_TIMEOUT = 900.0  # seconds each rank may take


def flagship_opts(input_size: str = "(64, 128)", node: str = "DeformConv",
                  k: int = 16) -> List[str]:
    """JAX's ``_flagship_config`` overrides (the defaults otherwise), in
    float32."""
    return ["MODEL.INPUT_SIZE", input_size, "MODEL.DLA.NODE", node,
            "MODEL.K", str(k), "MIXED_PRECISION", "False"]


def layout_of(n: int):
    """(n_data, n_spatial, n_model) of N ranks, as JAX picks its mesh."""
    n_spatial = 2 if n % 8 == 0 else 1
    n_model = 2 if n >= 4 and n % 2 == 0 else 1
    return n // (n_model * n_spatial), n_spatial, n_model


def jax_batch(cfg, n: int) -> Dict:
    """The dry run's global batch, NHWC numpy, drawn as
    ``__graft_entry__.py:110-141`` draws it."""
    rng = np.random.RandomState(0)
    b, m = max(n, 2), 8
    h, w = cfg.MODEL.INPUT_SIZE
    oh, ow = cfg.MODEL.OUTPUT_SIZE
    calib = np.array([[120.0, 0, ow / 2, 0], [0, 120.0, oh / 2, 0],
                      [0, 0, 1, 0]], np.float32)
    return {
        "image": rng.randn(b, h, w, 3).astype(np.float32),
        "pc_hm": np.abs(rng.randn(b, oh, ow, 3)).astype(np.float32),
        "pc_dep": np.abs(rng.randn(b, oh, ow, 3)).astype(np.float32),
        "calib": np.tile(calib, (b, 1, 1)),
        "heatmap0": np.zeros((b, oh, ow, 10), np.float32),
        "classIds": rng.randint(0, 10, (b, m)),
        "mask": np.ones((b, m), np.float32),
        "truncMask": np.zeros((b, m), np.float32),
        "widthHeight": rng.rand(b, m, 2).astype(np.float32) * 30,
        "reg": rng.rand(b, m, 2).astype(np.float32),
        "depth": rng.rand(b, m, 1).astype(np.float32) * 50,
        "dimension": rng.rand(b, m, 3).astype(np.float32) * 3,
        "amodal_offset": rng.randn(b, m, 2).astype(np.float32),
        "nuscenes_att": rng.randint(0, 2, (b, m, 8)).astype(np.float32),
        "nuscenes_att_mask": rng.randint(0, 2, (b, m, 8)).astype(np.float32),
        "velocity": rng.randn(b, m, 3).astype(np.float32),
        "rotbin": rng.randint(0, 2, (b, m, 2)),
        "rotres": rng.randn(b, m, 2).astype(np.float32) * 0.2,
        "target": {
            "heatCenters": np.stack(
                [rng.rand(b, m) * (ow - 1), rng.rand(b, m) * (oh - 1)], -1
            ).astype(np.float32),
            "bboxes": rng.rand(b, m, 4).astype(np.float32) * 30,
            "bboxes3d": rng.randn(b, m, 8, 3).astype(np.float32),
        },
    }


def _rows(batch, rows):
    return {k: _rows(v, rows) if isinstance(v, dict) else v[rows]
            for k, v in batch.items()}


def eval_step(model, cfg, image, pc_dep, calib):
    """(processed detections, heatmap, depth): the eval forward, decode and
    post-process (``trans_inv`` the identity, as in JAX)."""
    from ..ops.decode import fusion_decode
    from ..ops.postprocess import post_process

    outputs = model(image, pc_dep, calib)
    dets = fusion_decode([outputs], cfg.MODEL.OUTPUT_SIZE, k=cfg.MODEL.K)
    trans_inv = torch.eye(2, 3, dtype=image.dtype,
                          device=image.device).expand(image.shape[0], 2, 3)
    processed = post_process(dets, trans_inv, cfg.MODEL.OUTPUT_SIZE, calib)
    return processed, outputs["heatmap"], outputs["depth"]


def _float64(batch):
    return {k: _float64(v) if isinstance(v, dict) else (
        v.double() if v.is_floating_point() else v) for k, v in batch.items()}


def run_rank(n: int, rank: int, init_method: str, device: str,
             float64: bool = False) -> int:
    """One rank of the dry run; returns 0 when its checks passed."""
    from .. import parallel
    from ..config import load_config
    from ..data.pipeline import to_device
    from ..losses import GenericLoss
    from ..models import build_model
    from ..runtime.synthetic import seeded_weights
    from ..training import make_optimizer, train_step

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(init_method, n, rank, "gloo")
    n_data, n_spatial, n_model = layout_of(n)
    mesh = parallel.make_mesh(n_data, n_model, n_spatial, dev)
    cfg = load_config(opts=flagship_opts(), num_classes=10)
    dtype = torch.float64 if float64 else None
    model = build_model(cfg, dtype).to(dev)
    seeded_weights(model, 0)
    cast = _float64 if float64 else (lambda t: t)
    loss_fn = GenericLoss(cfg)
    batch = jax_batch(cfg, n)
    b = len(batch["image"])
    d = mesh.coords[parallel.DATA_AXIS]
    rows = list(range(d * b // n_data, (d + 1) * b // n_data))
    local = parallel.shard_batch(cast(to_device(_rows(batch, rows), dev)),
                                 mesh)

    parallel.shard_params_tp(model, mesh)
    optimizer = make_optimizer(cfg, model)
    metrics = train_step(model, optimizer, loss_fn, local, 1e-4, False, 1,
                         mesh)
    total = float(metrics["total"])
    assert np.isfinite(total), f"non-finite loss {total}"
    if rank == 0:
        print(f"dryrun_multichip({n}): train ok, loss={total:.4f} "
              f"(layout data {n_data} x spatial {n_spatial} x model "
              f"{n_model}, {dev})", flush=True)

    model.eval()
    with torch.no_grad(), parallel.layout(mesh):
        processed, hm, dep = eval_step(model, cfg, local["image"],
                                       local["pc_dep"], local["calib"])
    merged = parallel.gather_detections(processed, mesh)
    maps = parallel.gather_detections({"heatmap": hm, "depth": dep}, mesh)
    whole = parallel.unshard_state_dict(model, mesh)
    ok = True
    if rank == 0:
        single = build_model(cfg, dtype).to(dev)
        single.load_state_dict(whole)
        single.eval()
        full = cast(to_device(batch, dev))
        with torch.no_grad():
            want, hm1, dep1 = eval_step(single, cfg, full["image"],
                                        full["pc_dep"], full["calib"])
        want = {k: v.cpu().numpy() for k, v in want.items()}
        try:
            compare(n, total, merged, maps,
                    {"heatmap": hm1.cpu().numpy(),
                     "depth": dep1.cpu().numpy()}, want, b)
        except AssertionError as e:
            print(f"dryrun_multichip({n}): FAILED: {e}", flush=True)
            ok = False
    torch.distributed.barrier()  # the others wait for rank 0's check
    parallel.shutdown()
    return 0 if ok else 1


def compare(n, total, merged, maps, maps1, single, b) -> None:
    """JAX's checks of the layout's eval pass against one process (raises
    AssertionError); prints the last line."""
    for name in ("heatmap", "depth"):
        np.testing.assert_allclose(
            maps[name], maps1[name], rtol=RTOL, atol=ATOL,
            err_msg=f"eval {name} map: layout != one process")
    # the sorted scores are stable under top-K boundary ties
    np.testing.assert_allclose(
        np.sort(merged["scores"], axis=-1), np.sort(single["scores"],
                                                    axis=-1),
        rtol=RTOL, atol=ATOL, err_msg="eval sorted scores: layout != one "
        "process")
    for key, val in merged.items():
        arr = np.asarray(val)
        assert arr.shape[0] == b and np.isfinite(arr).all(), key
        assert arr.shape == np.asarray(single[key]).shape, key
    print(f"dryrun_multichip({n}): ok, loss={total:.4f}, eval maps + "
          f"sorted scores + {len(merged)} det keys match single-device",
          flush=True)


def launch(n: int, device: str, float64: bool = False) -> int:
    """Runs the dry run's ``n`` ranks as processes (``run_rank``), prints
    rank 0's two lines and every failed rank's log; returns the exit
    code."""
    if float64 and device != "cpu":
        raise ValueError("float64 runs on the CPU only (the DCN kernels take "
                         "float32 and bf16)")
    with tempfile.TemporaryDirectory(prefix="cfd_dryrun_") as tmp:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.environ.get("PYTHONPATH", "")
        env = {**os.environ, "OMP_NUM_THREADS": "2",
               "PYTHONPATH": root + (os.pathsep + path if path else "")}
        store = f"file://{os.path.join(tmp, 'store')}"
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from centerfusiondetect3d_tpu_torch.tools."
             "dryrun_multichip import run_rank; "
             f"sys.exit(run_rank({n}, {r}, {store!r}, {device!r}, "
             f"{bool(float64)}))"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
        finally:
            for p in procs:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    for r in failed:
        print(f"rank {r} failed (rc {procs[r].returncode}):\n"
              f"{logs[r][-4000:]}", file=sys.stderr)
    print("\n".join(line for line in logs[0].splitlines()
                    if line.startswith("dryrun_multichip(")), flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="processes (ranks)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.n < 1:
        raise SystemExit("dryrun_multichip: N must be at least 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: no CUDA device (pass --device "
                         "cpu to run on the CPU)")
    return launch(args.n, "cuda:0" if args.device == "cuda" else "cpu")


if __name__ == "__main__":
    sys.exit(main())
