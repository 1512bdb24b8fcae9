"""``tools/dcn_parity.py`` against ``scripts/measure_fast_dcn_parity.py``.

The JAX script (loaded with importlib; nothing there changes) measures each
head of the wide-offset goldens under a DCN implementation: ``xla`` (exact)
and ``shift`` (clamped to ±1 px, with the deep nodes' exact correction of
the largest offsets, ``shift_hybrid``). The port's tool gives the same rows
for its ``exact`` and ``clamped`` forms (the clamped kernels' arguments and
the same hybrid, composed in the tool). The cases are the script's: the
exact form on the loud fixture (the wide pair is held exactly against the
goldens by ``test_torch_model.py``), the clamped form on all three.

The comparison is on each head's RMS delta from the golden (``rel_rms`` x
``rms_want``) and its max abs delta: within ``ABS_TOL`` x (1 + the golden's
RMS), a few float32 spacings at the head's scale, plus ``REL_TOL`` of
JAX's. On the wide fixtures the heads' magnitudes are ~1e-6, so their
relative RMS is float32 noise of the two frameworks and is not compared
relatively. JAX's ``approx_max_k`` picks the exact top-k pixels on the CPU,
so ``DCN_CORRECT_APPROX`` stays as shipped.
"""

from __future__ import annotations

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import dcn
from centerfusiondetect3d_tpu_torch.tools import dcn_parity

pytest.importorskip("jax")
pytest.importorskip("centerfusiondetect3d_tpu.models")

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "measure_fast_dcn_parity.py")
ABS_TOL = 4e-7  # RMS and max abs delta of a head, x (1 + golden RMS) ...
REL_TOL = 1e-2  # ... plus this share of JAX's
CASES = [("exact", "xla", dcn_parity.CASES[2])] + [
    ("clamped", "shift", case) for case in dcn_parity.CASES]


@pytest.fixture(scope="module")
def jax_parity():
    spec = importlib.util.spec_from_file_location("measure_fast_dcn_parity",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("form,impl,case", CASES,
                         ids=[f"{f}-{c[0][14:-4]}" for f, _, c in CASES])
def test_rows_equal_the_scripts(form, impl, case, jax_parity):
    fixture, frustum, sd_fixture = case
    want = jax_parity.run(fixture, frustum, sd_fixture, impl)
    got = dcn_parity.run(fixture, frustum, sd_fixture, form, "cpu")
    assert got.keys() == want.keys() and len(got) >= 12
    for head, w in want.items():
        g = got[head]
        assert g["rms_want"] == pytest.approx(w["rms_want"], rel=1e-6,
                                              abs=1e-12), head
        for a, b in ((g["rel_rms"] * g["rms_want"],
                      w["rel_rms"] * w["rms_want"]),
                     (g["max_abs"], w["max_abs"])):
            assert abs(a - b) <= (ABS_TOL * (1 + w["rms_want"])
                                  + REL_TOL * abs(b)), (head, g, w)
    if fixture == "model_forward_dcn_loud.npz" and form == "clamped":
        # the clamp costs something visible here: the rows are not exact's
        exact = dcn_parity.run(fixture, frustum, sd_fixture, "exact", "cpu")
        assert max(g["rel_rms"] for g in got.values()) > 10 * max(
            e["rel_rms"] for e in exact.values())


def test_hybrid_recomputes_the_largest_offsets_exactly():
    """The deep-node form: the clamped result except at the top
    ``correct_frac`` pixels by max |offset| whose offset exceeds the
    clamp, which are the exact result; none where no offset does."""
    rng = np.random.RandomState(0)
    b, c, h, w, o = 2, 5, 6, 7, 3
    x = torch.from_numpy(rng.randn(b, c, h, w))
    offset = torch.from_numpy(rng.randn(b, 18, h, w) * 0.4)
    offset[1, 3, 2, 4] = 3.0  # the largest: recomputed
    offset[0, 7, 5, 1] = -2.5  # the second
    mask = torch.from_numpy(rng.rand(b, 9, h, w))
    weight = torch.from_numpy(rng.randn(o, c, 3, 3))
    bias = torch.from_numpy(rng.randn(o))
    frac = 2.0 / (b * h * w)  # two pixels
    got = dcn_parity.deform_conv2d_hybrid(x, offset, mask, weight, bias,
                                          max_offset=1.0, correct_frac=frac)
    exact = dcn.deform_conv2d_plain(x, offset, mask, weight, bias)
    clamped = dcn.deform_conv2d_plain(x, offset, mask, weight, bias, 1.0)
    want = clamped.clone()
    for bi, yi, xi in ((1, 2, 4), (0, 5, 1)):
        want[bi, :, yi, xi] = exact[bi, :, yi, xi]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, clamped)
    small = offset.clamp(-0.9, 0.9)
    torch.testing.assert_close(
        dcn_parity.deform_conv2d_hybrid(x, small, mask, weight, bias,
                                        correct_frac=frac),
        dcn.deform_conv2d_plain(x, small, mask, weight, bias, 1.0),
        rtol=0, atol=0)


def test_forms_set_every_node():
    """``exact`` restores ``deform_conv2d``; ``clamped`` clamps the shallow
    nodes and makes the ``DCN_DEEP_MIN_CH`` ones hybrid."""
    from centerfusiondetect3d_tpu_torch.config import load_config
    from centerfusiondetect3d_tpu_torch.models import build_model
    from centerfusiondetect3d_tpu_torch.models.layers import DeformConvNode

    cfg = load_config(opts=["MODEL.INPUT_SIZE", "(64, 128)",
                            "MODEL.DLA.NODE", "DeformConv"], num_classes=10)
    model = build_model(cfg)
    nodes = [m for m in model.modules() if isinstance(m, DeformConvNode)]
    deep = dcn_parity.set_form(model, "clamped", cfg)
    assert deep == sum(n.weight.shape[1] >= 256 for n in nodes) > 0
    for n in nodes:
        assert isinstance(n.dcn_fn, functools.partial)
        assert n.dcn_fn.keywords["max_offset"] == 1.0
        assert (n.dcn_fn.func is dcn_parity.deform_conv2d_hybrid) == (
            n.weight.shape[1] >= 256)
    assert dcn_parity.set_form(model, "exact", cfg) == 0
    assert all(n.dcn_fn is dcn.deform_conv2d for n in nodes)
