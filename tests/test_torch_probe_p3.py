"""``p3``, the scalar reduce of ``scripts/probe_mosaic.py:98``, and its kernel
(``csrc/dcn_probes.cu:shift_if_max_kernel``).

``p3`` computes x + trunc(min x) where max x > 0.5, else zeros. The plain
version (``probes.probe_p3_plain``) is held here against the script's
kernel in interpret mode (the loader of ``tests/test_torch_probes.py``) on
the inputs no other test gives it: a NaN anywhere gives zeros (``jnp.max``
and ``torch.max`` propagate NaN, so max x > 0.5 is false), and a -inf
gives the int32 cast of -inf, -2^31, added to every element.

The kernel reads x once, in float4s where x and the output start on 16
bytes (``probes.p3_width``) with the n % 4 tail as floats, else as floats,
and reduces with NaN-propagating min and max. Its ``cuda`` cases hold it
bitwise (int32 bits) against the plain version on the card: the tool's
three inputs, NaN at the head, middle and tail, -inf, +inf, lengths that
are not a multiple of 4 (2047, 2049, 1, 3, 5), a length beyond what the
block keeps in registers, and an x that starts off 16 bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_probes import SEED, _jax_p5, _np

from centerfusiondetect3d_tpu_torch.ops import probes
from centerfusiondetect3d_tpu_torch.tools import probe_dcn

SHAPE = (16, 128)  # the script's block
INT32_MIN = float(-2 ** 31)


def _special(case: str, shape=SHAPE) -> np.ndarray:
    """Ones (max 1 > 0.5, so the select is on) with a NaN or an infinity
    written in; ``nan_negative`` puts the NaN among N(0, 1) values."""
    if case == "nan_negative":
        x = np.random.RandomState(SEED).randn(*shape).astype(np.float32)
    else:
        x = np.ones(shape, np.float32)
    flat = x.reshape(-1)
    n = flat.size
    if case in ("nan", "nan_negative"):
        flat[n // 3] = np.nan
    elif case == "nan_last":
        flat[n - 1] = np.nan
    elif case == "nan_first":
        flat[0] = np.nan
    elif case == "minus_inf":
        flat[n // 2] = -np.inf
    elif case == "plus_inf":
        flat[n // 2] = np.inf
    else:
        raise KeyError(case)
    return x


@pytest.mark.parametrize("case", ["nan", "nan_negative", "minus_inf"])
def test_p3_plain_matches_jax_interpret_on_nan_and_inf(case):
    import jax.numpy as jnp

    fn = _jax_p5("p3")["fn"]
    x = _special(case)
    want = _np(fn(jnp.asarray(x)))
    got = probes.probe_p3_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if case.startswith("nan"):
        assert not got.any()  # a NaN anywhere: zeros
    else:
        finite = np.isfinite(x)
        np.testing.assert_array_equal(got[finite], x[finite] + INT32_MIN)
        assert np.isneginf(got[~finite]).all()


def test_p3_width_is_float4_only_on_16_bytes():
    buf = torch.zeros(2 * 2048 + 8)
    x = buf[:2048]
    off = buf[1:2049]
    out = torch.empty(2048)
    assert x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    assert probes.p3_width(x, out) == 4
    assert probes.p3_width(off, out) == 1
    assert probes.p3_width(x, buf[2049:4097]) == 1


def test_p3_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    before = probes.probe_p3.launches
    for case in ("nan", "minus_inf", "plus_inf", "nan_last"):
        x = torch.from_numpy(_special(case))
        assert torch.equal(probes.probe_p3(x), probes.probe_p3_plain(x))
    x = torch.arange(2047, dtype=torch.float32) - 3.5
    np.testing.assert_array_equal(probes.probe_p3(x).numpy(),
                                  (x - 3.0).numpy())
    assert probes.probe_p3.launches == before


# -------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _held(x):
    before = probes.probe_p3.launches
    got = probes.probe_p3(x)
    want = probes.probe_p3_plain(x)
    torch.cuda.synchronize()
    assert probes.probe_p3.launches == before + 1
    assert torch.equal(_bits(got), _bits(want)), (
        float((got - want).abs().nan_to_num(0).max()))
    return got


# beyond the registers: 256 threads x 4 float4s = 4096 floats, then more
LENGTHS = [1, 3, 4, 5, 2047, 2048, 2049, 4096 * 2 + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(3))
def test_p3_kernel_bitwise_on_the_tool_inputs(index):
    dev = _card()
    label, args, expected = probe_dcn.p5_cases("p3", SEED, dev)[index]
    got = _held(*args)
    if expected is not None:
        assert torch.equal(got, expected), label


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nan", "nan_negative", "nan_first",
                                  "nan_last", "minus_inf", "plus_inf"])
@pytest.mark.parametrize("n", [2048, 2047])
def test_p3_kernel_repair_cases_bitwise(case, n):
    """NaN gives zeros (the old kernel's fminf/fmaxf skipped it), -inf the
    saturating cast -2^31, as the plain version does on the card."""
    dev = _card()
    x = torch.from_numpy(_special(case, (n,))).to(dev)
    got = _held(x)
    if case.startswith("nan"):
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", LENGTHS)
def test_p3_kernel_ragged_lengths_bitwise(n):
    dev = _card()
    rng = np.random.RandomState(SEED + n)
    x = torch.from_numpy(rng.randn(n).astype(np.float32) + 0.7).to(dev)
    x.view(-1)[::7] = -0.0
    _held(x)
    if n > 4:
        y = x.clone()
        y[n - 2] = float("nan")  # in the tail or the last vector
        assert not _held(y).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2047, 2048])
def test_p3_kernel_on_an_x_off_16_bytes(n):
    dev = _card()
    buf = torch.from_numpy(np.random.RandomState(SEED).randn(n + 1).astype(
        np.float32)).to(dev) + 1.0
    x = buf[1:]
    assert x.data_ptr() % 16 != 0
    _held(x)
    y = x.clone()
    y[n // 2] = float("nan")
    assert not _held(y[1:] if n % 2 else y).any()


@pytest.mark.cuda
def test_p3_entry_refuses_a_wrong_width():
    dev = _card()
    buf = torch.ones(2049, device=dev)
    x, out = buf[1:], torch.empty(2048, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        probes._run(x, "cfd_probe_p3", x.data_ptr(), out.data_ptr(),
                    x.numel(), 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        probes._run(x, "cfd_probe_p3", x.data_ptr(), out.data_ptr(),
                    x.numel(), 2)
