"""Per-head deltas of the clamped DCN forms against the wide-offset goldens.

The port of ``scripts/measure_fast_dcn_parity.py``. The goldens are
executed torch-reference forwards (``tests/fixtures/``) at 64x128 whose
DCN offsets reach well past one pixel: ``model_forward_dcn_wide.npz``,
``model_forward_dcn_wide_frustum.npz`` (with ``_wide``'s weights) and
``model_forward_dcn_loud.npz`` (BatchNorm-calibrated features with ~1.5 px
offsets, where a ±1 px clamp costs something visible). For each, the model
(float32, the golden's own state_dict) runs with each DCN form and every
head is compared with the golden: relative RMS, max abs, the golden's RMS.

Two forms, set on every ``DeformConvNode.dcn_fn`` (the model itself always
runs the exact DCN; ``MODEL.DLA.DCN_IMPL`` and ``DCN_MAX_OFFSET`` are
ignored there and read here):

- ``exact``: ``ops/dcn.py:deform_conv2d``, no clamp (the JAX ``xla`` rows);
- ``clamped``: ``deform_conv2d(..., max_offset=DCN_MAX_OFFSET)`` at nodes
  with fewer than ``DCN_DEEP_MIN_CH`` input channels; at the deep ones the
  JAX package's ``shift_hybrid`` (``ops/dcn.py:154`` there): the clamped
  result with the ``DCN_CORRECT_FRAC`` largest-offset pixels recomputed
  exactly (exact top-k), composed here from the port's exact and clamped
  calls. The JAX ``select`` and ``shift`` rows are this one form: on a GPU
  both are the same clamped op (``dcn_fwd*`` with ``max_offset``), and their
  differences are TPU code paths.

The fixtures are not copied to the card, so this runs where the repository
is whole: ``--device cpu`` here (the card is the default, as for every entry
point). It prints one markdown table per form and fixture.

    python -m centerfusiondetect3d_tpu_torch.tools.dcn_parity --device cpu
        [--fixtures tests/fixtures] [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import functools
import json
import os

import numpy as np
import torch

from ..config import load_config
from ..models import build_model
from ..models.layers import DeformConvNode
from ..ops.dcn import deform_conv2d
from ..utils.device import resolve_device

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")
# (fixture, frustum, the fixture holding its weights)
CASES = (
    ("model_forward_dcn_wide.npz", False, None),
    ("model_forward_dcn_wide_frustum.npz", True, "model_forward_dcn_wide.npz"),
    ("model_forward_dcn_loud.npz", False, None),
)
FORMS = ("exact", "clamped")
FORM_TITLES = {"exact": "exact",
               "clamped": "clamped (±{r:g}, deep hybrid)"}


def deform_conv2d_hybrid(x, offset, mask, weight, bias=None, *,
                         max_offset: float = 1.0, correct_frac: float = 0.03):
    """The clamped DCN with the ``correct_frac`` pixels of largest |offset|
    recomputed exactly where that offset exceeds ``max_offset`` (JAX
    ``deform_conv2d_shift_hybrid`` with exact top-k; NCHW)."""
    base = deform_conv2d(x, offset, mask, weight, bias, max_offset=max_offset)
    exact = deform_conv2d(x, offset, mask, weight, bias)
    b, o, h, w = base.shape
    n = b * h * w
    m = max(1, min(n, int(round(n * float(correct_frac)))))
    overflow = offset.abs().amax(dim=1).reshape(n)  # (B*H*W,) pixel order
    vals, idx = torch.topk(overflow, m)
    idx = idx[vals > float(max_offset)]
    flat = base.permute(0, 2, 3, 1).reshape(n, o).clone()
    flat[idx] = exact.permute(0, 2, 3, 1).reshape(n, o)[idx]
    return flat.reshape(b, h, w, o).permute(0, 3, 1, 2).contiguous()


def set_form(model, form: str, cfg) -> int:
    """Sets every DeformConv node's ``dcn_fn`` for ``form``; returns the
    number of deep (hybrid) nodes."""
    dla = cfg.MODEL.DLA
    r = float(dla.DCN_MAX_OFFSET)
    deep = 0
    for node in model.modules():
        if not isinstance(node, DeformConvNode):
            continue
        if form == "exact":
            node.dcn_fn = deform_conv2d
        elif node.weight.shape[1] >= int(dla.DCN_DEEP_MIN_CH):
            node.dcn_fn = functools.partial(
                deform_conv2d_hybrid, max_offset=r,
                correct_frac=float(dla.DCN_CORRECT_FRAC))
            deep += 1
        else:
            node.dcn_fn = functools.partial(deform_conv2d, max_offset=r)
    return deep


def run(fixture: str, frustum: bool, sd_fixture, form: str, device="cpu",
        fixtures: str = FIXTURES, opts=()):
    """{head: {rel_rms, max_abs, rms_want}} of ``form`` on ``fixture``."""
    g = np.load(os.path.join(fixtures, fixture))
    cfg = load_config(
        opts=["MODEL.INPUT_SIZE", "(64, 128)", "MODEL.DLA.NODE", "DeformConv",
              "DATASET.RADAR_PC", "True", "MODEL.FRUSTUM", str(frustum),
              "MODEL.FUSION_STRATEGY", "'middle'",
              "MIXED_PRECISION", "False"] + list(opts),
        num_classes=10)
    head_conv = json.loads(bytes(g["meta_head_conv"]).decode())
    if {k: list(v) for k, v in cfg.head_conv.items()} != head_conv:
        raise ValueError(f"{fixture}: head towers {head_conv} are not the "
                         f"config's {dict(cfg.head_conv)}")
    src = g if sd_fixture is None else np.load(os.path.join(fixtures,
                                                            sd_fixture))
    device = resolve_device(device)
    model = build_model(cfg)
    model.load_state_dict({k[3:]: torch.from_numpy(src[k])
                           for k in src.files if k.startswith("sd_")},
                          strict=True)
    model = model.to(device).eval()
    set_form(model, form, cfg)
    with torch.no_grad():
        y = model(*(torch.from_numpy(g[k]).to(device)
                    for k in ("in_img", "in_pc_dep", "in_calib")))
    rows = {}
    for key in g.files:
        if not key.startswith("out_") or key == "out_calib":
            continue
        name = key[4:]
        want = g[key].astype(np.float64)
        d = y[name].double().cpu().numpy() - want
        rms_w = float(np.sqrt(np.mean(want ** 2)))
        rows[name] = {
            "rel_rms": float(np.sqrt(np.mean(d ** 2))) / max(rms_w, 1e-12),
            "max_abs": float(np.max(np.abs(d))),
            "rms_want": rms_w,
        }
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--fixtures", default=FIXTURES,
                    help="the directory of the model_forward_dcn_*.npz "
                         "goldens")
    ap.add_argument("opts", nargs="*", default=[],
                    help="dotted overrides, e.g. MODEL.DLA.DCN_MAX_OFFSET 2.0")
    args = ap.parse_args(argv)
    missing = [c[0] for c in CASES
               if not os.path.exists(os.path.join(args.fixtures, c[0]))]
    if missing:
        raise SystemExit(f"dcn_parity: no {', '.join(missing)} under "
                         f"{args.fixtures} (the goldens are in the "
                         "repository's tests/fixtures)")
    r = float(load_config(opts=list(args.opts)).MODEL.DLA.DCN_MAX_OFFSET)
    out = {}
    for form in FORMS:
        for fixture, frustum, sd_fixture in CASES:
            rows = run(fixture, frustum, sd_fixture, form, args.device,
                       args.fixtures, args.opts)
            out[(form, fixture)] = rows
            print(f"\n### {FORM_TITLES[form].format(r=r)} vs {fixture}")
            print("| head | rel RMS | max abs | golden RMS |")
            print("|---|---|---|---|")
            for name in sorted(rows):
                row = rows[name]
                print(f"| {name} | {row['rel_rms']:.3e} | "
                      f"{row['max_abs']:.3e} | {row['rms_want']:.3e} |")
    return out


if __name__ == "__main__":
    main()
