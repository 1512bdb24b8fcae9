"""The DCN probe kernels (``ops/probes.py``, ``csrc/dcn_probes.cu``) against
the probe scripts' Pallas kernels, run in interpret mode.

Each script (``scripts/probe_dcn_bisect.py``, ``probe_dcn_bisect2.py``,
``probe_dcn_bisect3.py``, ``probe_mosaic.py``) is loaded with importlib;
nothing in ``scripts/`` changes. The loaded module's global ``pl`` is
replaced by a stand-in whose ``pallas_call(kernel, **kw)`` records the
kernel, its specs and the operands it is called on, and returns the real
``pallas_call(kernel, **kw, interpret=True)`` (jitted): the scripts' own
``call()`` and ``p1()``...``p4()`` then run on the CPU, and each recorded
kernel runs again, with its own specs, on seeded inputs. Setting the loaded
module's ``BR, W, C, O, HP, WP`` runs the tile probes at the port's second
geometry.

Each plain version (``probe_*_plain``, what the wrappers run on CPU
tensors and what the card's kernels are held against) is held against the
JAX kernel: the tile probes at both geometries, on the script's inputs and
on two seeded draws (offsets U(-1.5, 1.5) as P3 draws them, and U(-10, 10)
so that the +-8 clip binds; x N(0, 1) and w 0.1 N(0, 1) rounded to bf16,
mask U(0, 1)); the P5 probes on the inputs of each test. Tolerances,
relative to the JAX result's largest magnitude, are each probe's ``rtol``
in ``PROBES``: 0 (bitwise) for copies, counts and small exact sums
(``k2``, ``ka``, ``p1``, ``p2``, ``p3``); 1e-5 for float32 sums of bf16
inputs, summed in another order (``k1``, ``k3``, ``k4``, ``kb``...``kg``)
and for ``p4``'s 64 exact products; 8e-3 (two bf16 ulps) for ``k5``, where
another order of the tap sums can flip its one bf16 rounding.

The ``cuda``-marked test holds every kernel against its plain version on
the card (it decides in its body whether there is one).
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from centerfusiondetect3d_tpu_torch.ops import probes
from centerfusiondetect3d_tpu_torch.ops.probes import (
    GEOMETRIES,
    PROBES,
    Geometry,
)
from centerfusiondetect3d_tpu_torch.tools import probe_dcn

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 0
TILE_PROBES = [n for n, p in PROBES.items()
               if not p.script.endswith("probe_mosaic.py")]
# the operands of each script's pallas_call, in order
OPERANDS = {"scripts/probe_dcn_bisect.py": ("off", "mask", "x", "w"),
            "scripts/probe_dcn_bisect2.py": ("off", "x"),
            "scripts/probe_dcn_bisect3.py": ("off", "x")}

_MODULES = {}
_JAX_TILE = {}
_JAX_P5 = {}


class _Recorder:
    """Stands in for a script's ``pl``: ``pallas_call`` records and runs in
    interpret mode; everything else is the real ``pallas``."""

    def __init__(self, pallas, jax):
        self.pallas, self.jax, self.calls = pallas, jax, []

    def __getattr__(self, name):
        return getattr(self.pallas, name)

    def pallas_call(self, kernel, **kw):
        fn = self.jax.jit(self.pallas.pallas_call(kernel, **kw,
                                                  interpret=True))
        call = {"kernel": kernel, "kw": kw, "fn": fn}
        self.calls.append(call)

        def run(*operands):
            call["operands"] = operands
            return fn(*operands)

        return run


def _script(path: str):
    """The script at ``path`` (relative to the repo), loaded with its
    ``pl`` replaced by a :class:`_Recorder`."""
    if path not in _MODULES:
        jax = pytest.importorskip("jax")
        from jax.experimental import pallas

        spec = importlib.util.spec_from_file_location(
            pathlib.Path(path).stem, ROOT / path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        module.pl = _Recorder(pallas, jax)
        _MODULES[path] = module
    return _MODULES[path]


def _at(module, geom: Geometry):
    module.BR, module.W, module.C, module.O = geom.br, geom.w, geom.c, geom.o
    module.HP, module.WP = geom.hp, geom.wp


def _jax_tile(name: str, geom: Geometry):
    """(recorded call, the script's own result) of tile probe ``name`` run
    by its script's ``call()`` at ``geom``."""
    key = (name, geom)
    if key not in _JAX_TILE:
        module = _script(PROBES[name].script)
        _at(module, geom)
        result = module.call(getattr(module, name))
        _JAX_TILE[key] = module.pl.calls[-1], result
    return _JAX_TILE[key]


def _jax_p5(name: str):
    """The recorded call of P5 probe ``name``, run by the script's own
    probe function (its closure kernel, its specs)."""
    if name not in _JAX_P5:
        module = _script(PROBES[name].script)
        getattr(module, name)()
        _JAX_P5[name] = module.pl.calls[-1]
    return _JAX_P5[name]


def _jnp(t):
    import jax.numpy as jnp

    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a):
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    scale = float(np.abs(want).max())
    return err / scale if scale > 0 else (0.0 if err == 0 else np.inf)


def _geom_id(g: Geometry) -> str:
    return f"br{g.br}w{g.w}c{g.c}o{g.o}"


@pytest.mark.parametrize("case", probe_dcn.CASES)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
@pytest.mark.parametrize("name", TILE_PROBES)
def test_tile_probe_plain_matches_jax_interpret(name, geom, case):
    probe = PROBES[name]
    call, script_result = _jax_tile(name, geom)
    inputs = probe_dcn.tile_inputs(probe.script, geom, case, SEED, "cpu")
    order = OPERANDS[probe.script]
    if case == "script":
        # the port's copy of the script's inputs is the script's own
        for key, operand in zip(order, call["operands"]):
            np.testing.assert_array_equal(_np(operand),
                                          inputs[key].float().numpy())
        want = script_result[0] if isinstance(script_result, tuple) \
            else script_result
    else:
        want = call["fn"](*[_jnp(inputs[k]) for k in order])
    got = probe.plain(*[inputs[k] for k in probe.kernel.inputs], geom)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= probe.rtol


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
def test_port_oracle_is_the_p3_oracle(geom):
    """``tools/probe_dcn.py:bilinear_oracle`` (vectorized) against P3's
    ``_oracle`` on the script's own inputs; kf and kg within 1e-5 of it."""
    _, (_, oracle) = _jax_tile("kf", geom)
    inputs = probe_dcn.tile_inputs(PROBES["kf"].script, geom, "script",
                                   SEED, "cpu")
    port = probe_dcn.bilinear_oracle(inputs["x"].float().numpy(),
                                     inputs["off"].numpy(), geom)
    assert port.dtype == np.float32
    assert _rel(port, oracle) <= 1e-6
    for name in ("kf", "kg"):
        got = probes.PROBES[name].plain(inputs["x"], inputs["off"], geom)
        assert _rel(got.numpy(), oracle) <= probe_dcn.ORACLE_RTOL


@pytest.mark.parametrize("geom", GEOMETRIES, ids=_geom_id)
def test_kd_kg_compute_k4_kf_and_the_ke_cut(geom):
    """The scripts' own kd and kg (a linearized loop, a column roll)
    compute the functions of their k4 and kf, on both draws: why each pair
    shares its plain version and its device code in the port. ke's gy cut
    to [-2, 2] binds only on the wide draw."""
    for case in ("narrow", "wide"):
        inp = probe_dcn.tile_inputs(PROBES["k4"].script, geom, case, SEED,
                                    "cpu")
        jax_out = {}
        for name in ("k4", "kd", "kf", "kg"):
            call, _ = _jax_tile(name, geom)
            order = OPERANDS[PROBES[name].script]
            jax_out[name] = call["fn"](*[_jnp(inp[k]) for k in order])
        assert _rel(jax_out["kd"], jax_out["k4"]) <= probes.SUMS
        assert _rel(jax_out["kg"], jax_out["kf"]) <= probes.SUMS
        x, off = inp["x"], inp["off"]
        k4 = probes.probe_k4_plain(x, off, geom)
        ke = probes.probe_ke_plain(x, off, geom)
        ylo, yhi, _, _ = probes.tile_bounds(off, geom)
        if case == "narrow":
            assert int(ylo.min()) >= -2 and int(yhi.max()) <= 2
            assert torch.equal(ke, k4)
        else:
            assert int(ylo.min()) < -2 and int(yhi.max()) > 2
            assert _rel(ke.numpy(), k4.numpy()) > 0.1


def test_k3_and_kb_read_the_same_rows_in_both_row_blocks():
    """k3 and kb have no rb*BR term: with equal bounds in both tiles of a
    batch (zero offsets), both row blocks give the same values; kc, with
    the term, does not."""
    geom = probes.SCRIPT_GEOMETRY
    inp = probe_dcn.tile_inputs(PROBES["kb"].script, geom, "narrow", SEED,
                                "cpu")
    off = torch.zeros_like(inp["off"])
    for fn, same in ((probes.probe_k3_plain, True),
                     (probes.probe_kb_plain, True),
                     (probes.probe_kc_plain, False)):
        out = fn(inp["x"], off, geom)
        top, bottom = out[:, :geom.br], out[:, geom.br:]
        assert torch.equal(top, bottom) == same, fn.__name__


@pytest.mark.parametrize("g", [0, 3, 8])
def test_p1_plain_matches_jax_interpret(g):
    import jax.numpy as jnp

    fn = _jax_p5("p1")["fn"]
    rng = np.random.RandomState(SEED + g)
    for x in (np.arange(24 * 32 * 128, dtype=np.float32).reshape(24, 32, 128),
              rng.randn(24, 32, 128).astype(np.float32)):
        want = fn(jnp.array([g], jnp.int32), jnp.asarray(x))
        got = probes.probe_p1_plain(torch.from_numpy(x), g)
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("lo,hi", [(2, 6), (0, 25), (5, 5)])
def test_p2_plain_matches_jax_interpret(lo, hi):
    import jax.numpy as jnp

    fn = _jax_p5("p2")["fn"]
    rng = np.random.RandomState(SEED + lo)
    for x in (np.ones((32, 128), np.float32),
              rng.randn(32, 128).astype(np.float32)):
        want = fn(jnp.array([lo, hi], jnp.int32), jnp.asarray(x))
        got = probes.probe_p2_plain(torch.from_numpy(x), lo, hi)
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("case", ["ones", "normal", "minus_ones"])
def test_p3_plain_matches_jax_interpret(case):
    """p3's cast truncates toward zero: on the N(0, 1) draw the minimum is
    negative and not an integer, where a floor would differ."""
    import jax.numpy as jnp

    fn = _jax_p5("p3")["fn"]
    x = {"ones": np.ones((16, 128), np.float32),
         "normal": np.random.RandomState(SEED).randn(16, 128).astype(
             np.float32),
         "minus_ones": -np.ones((16, 128), np.float32)}[case]
    want = _np(fn(jnp.asarray(x)))
    got = probes.probe_p3_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "normal":
        lo = x.min()
        assert lo < 0 and np.trunc(lo) != np.floor(lo)
        np.testing.assert_array_equal(got, x + np.trunc(lo))
    elif case == "minus_ones":
        assert not got.any()  # max -1 is not above 0.5


@pytest.mark.parametrize("case", ["script", "seeded"])
def test_p4_plain_matches_jax_interpret(case):
    """On the script's inputs (ones) the kernel computes bf16(1 * 2) summed
    over 64 channels: 128. The script asserts 256, which is wrong (its
    interpret run fails with ACTUAL 128, DESIRED 256); the port computes
    what the kernel computes."""
    call = _jax_p5("p4")
    if case == "script":
        x, w = (torch.from_numpy(_np(a)).bfloat16() for a in call["operands"])
        assert bool((x == 1).all()) and bool((w == 1).all())
        want = _np(call["fn"](*call["operands"]))
        np.testing.assert_array_equal(want, np.full((8, 16, 128), 128.0))
    else:
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randn(16, 32, 64).astype(np.float32)
                             ).bfloat16()
        w = torch.from_numpy((0.1 * rng.randn(64, 128)).astype(np.float32)
                             ).bfloat16()
        want = _np(call["fn"](_jnp(x), _jnp(w)))
    got = probes.probe_p4_plain(x, w).numpy()
    assert _rel(got, want) <= PROBES["p4"].rtol


def test_script_k6_is_stale():
    """P1's k6 passes NCHW-like (1, 18, BR, W) offset blocks to K1, which
    reads NHWC (1, BR, W, 18) now: the script's own call fails. Its
    counterpart is K1 itself (``probes.probe_k6``, ``dcn_fwd_bf16``)."""
    module = _script("scripts/probe_dcn_bisect.py")
    _at(module, probes.SCRIPT_GEOMETRY)
    with pytest.raises(TypeError, match="broadcast"):
        module.call(module.k6)


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    geom = probes.SECOND_GEOMETRY
    before = probes.launch_counts()
    for name in TILE_PROBES:
        probe = PROBES[name]
        inp = probe_dcn.tile_inputs(probe.script, geom, "wide", SEED, "cpu")
        args = [inp[k] for k in probe.kernel.inputs]
        assert torch.equal(probe.kernel(*args, geom=geom),
                           probe.plain(*args, geom))
    for name in ("p1", "p2", "p3", "p4"):
        for _, args, expected in probe_dcn.p5_cases(name, SEED, "cpu"):
            got = PROBES[name].kernel(*args)
            assert torch.equal(got, PROBES[name].plain(*args))
            if expected is not None:
                assert torch.equal(got, expected)
    assert probes.launch_counts() == before


def test_wrappers_raise_without_a_kernel():
    geom = probes.SCRIPT_GEOMETRY
    inp = probe_dcn.tile_inputs(PROBES["k5"].script, geom, "narrow", SEED,
                                "meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        probes.probe_k5(inp["x"], inp["off"], inp["mask"], inp["w"])
    with pytest.raises(RuntimeError, match="no kernel"):
        probes.probe_p3(torch.ones((16, 128), device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe_dcn.main(["--device", "cuda"])


def test_wrappers_raise_on_a_geometry_that_leaves_x():
    with pytest.raises(ValueError, match="leave x"):
        Geometry(pad=8)
    geom = probes.SCRIPT_GEOMETRY
    inp = probe_dcn.tile_inputs(PROBES["k4"].script, geom, "narrow", SEED,
                                "cpu")
    x, off = inp["x"], inp["off"]
    with pytest.raises(ValueError):  # HP one row short
        probes.probe_k4(x[:, 1:].contiguous(), off)
    with pytest.raises(ValueError):  # x not at this geometry
        probes.probe_kf(x, off, geom=probes.SECOND_GEOMETRY)
    with pytest.raises(TypeError):
        probes.probe_k4(x.float(), off)
    with pytest.raises(ValueError):
        probes.probe_k1(x.transpose(1, 2))
    x3 = torch.zeros((24, 32, 128))
    for g in (-1, 16):
        with pytest.raises(ValueError, match="outside x"):
            probes.probe_p1(x3, g)
    for lo, hi in ((0, 26), (3, 2), (-1, 2)):
        with pytest.raises(ValueError, match="outside x"):
            probes.probe_p2(torch.zeros((32, 128)), lo, hi)
    with pytest.raises(ValueError, match="leaves x"):
        probes.probe_p4(torch.zeros((9, 32, 64), dtype=torch.bfloat16),
                        torch.zeros((64, 128), dtype=torch.bfloat16))


def test_probe_tool_passes_on_cpu():
    lines = []
    results = probe_dcn.run("cpu", SEED, out=lines.append)
    assert all(r.passed for r in results), [r.line() for r in results]
    names = [r.script_name for r in results]
    assert len(names) == 18 and names[5] == "k6_full_kernel"
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        f"[probe] {n}" for n in names]
    assert lines[-1].startswith("SUMMARY: ")
    only = probe_dcn.run("cpu", SEED, only=["k4", "kg_dynamic_roll"],
                         out=lambda s: None)
    assert [r.name for r in only] == ["k4", "kg"]
    assert "TPU" not in "\n".join(lines)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROBES))
def test_probe_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = PROBES[name].kernel.launches
    res = probe_dcn.check(name, torch.device("cuda"), SEED)
    torch.cuda.synchronize()
    assert res.passed, res.line()
    assert PROBES[name].kernel.launches > before
