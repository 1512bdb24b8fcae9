"""Run the DCN probe kernels and hold each against its plain version.

    python -m centerfusiondetect3d_tpu_torch.tools.probe_dcn             # card
    python -m centerfusiondetect3d_tpu_torch.tools.probe_dcn --device cpu
    python -m centerfusiondetect3d_tpu_torch.tools.probe_dcn --only k4 kf

The port of the ``__main__`` of the probe scripts ``scripts/
probe_dcn_bisect.py``, ``probe_dcn_bisect2.py``, ``probe_dcn_bisect3.py``
and ``probe_mosaic.py``. Every probe of ``ops/probes.py`` runs its kernel
(on the card; on the CPU its plain version) on the scripts' own inputs and
on inputs drawn from ``--seed``, and is held against its plain version on
the same device within its tolerance. The tile probes run at the scripts'
geometry (BR, W, C, O = 8, 24, 16, 16) and at a second one (4, 40, 8, 32),
each with the script's inputs and two seeded draws: offsets U(-1.5, 1.5),
as P3 draws them, and U(-10, 10), past the +-8 clip. ``kf`` and ``kg`` are
also held against P3's bilinear oracle (a numpy copy here), the P5 probes
against the scripts' expected values where those are right (``p4``'s is
not: the kernel gives 128 on its inputs, the script asserts 256), and K1 at
the probes' shapes (``k6``, ``p5``) runs ``dcn_fwd_bf16`` against its plain
version. One ``[probe] <script name>: PASS|FAIL ...`` line per probe, then
a ``SUMMARY:`` line; the exit code is 1 if any probe failed.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import dcn, probes
from ..ops.probes import GEOMETRIES, K1_PROBES, K1_RTOL, PROBES, Geometry
from ..utils.device import resolve_device

CASES = ("script", "narrow", "wide")
OFFSET_SCALE = {"narrow": 1.5, "wide": 10.0}
ORACLE_RTOL = 1e-5  # kf, kg against the bilinear oracle: sums in float32
P5_SCRIPT_ATOL = 2e-3  # the script's atol for K1 against the exact DCN


def _tensor(a, device, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        device=device, dtype=dtype)


def tile_inputs(script: str, geom: Geometry, case: str, seed: int,
                device) -> Dict[str, torch.Tensor]:
    """x, off, mask, w of a tile probe. "script": the script's own (P1 and
    P2: x and mask ones, offsets zero, w ones; P3: x N(0, 1) and offsets
    U(-1.5, 1.5) from ``RandomState(0)``); "narrow" / "wide": x N(0, 1),
    offsets U(-s, s) with s = 1.5 / 10, mask U(0, 1), w 0.1 N(0, 1), from
    ``RandomState(seed + 1)`` / ``RandomState(seed + 2)`` (P3's own draw
    is ``RandomState(0)``); x and w rounded to bf16."""
    g = geom
    xs, fs, ms, ws = ((g.batch, g.hp, g.wp, g.c), (g.batch, 18, g.h, g.w),
                      (g.batch, 9, g.h, g.w), (9, g.c, g.o))
    if case == "script" and not script.endswith("probe_dcn_bisect3.py"):
        x, off, mask, w = np.ones(xs), np.zeros(fs), np.ones(ms), np.ones(ws)
    elif case == "script":
        rng = np.random.RandomState(0)
        x = rng.randn(*xs).astype(np.float32)
        off = (rng.rand(*fs) * 3 - 1.5).astype(np.float32)
        mask, w = np.ones(ms), np.ones(ws)
    else:
        rng = np.random.RandomState(seed + 1 + (case == "wide"))
        s = OFFSET_SCALE[case]
        x = rng.randn(*xs)
        off = rng.uniform(-s, s, fs)
        mask = rng.rand(*ms)
        w = 0.1 * rng.randn(*ws)
    return {"x": _tensor(x, device, torch.bfloat16),
            "off": _tensor(off, device), "mask": _tensor(mask, device),
            "w": _tensor(w, device, torch.bfloat16)}


def p5_cases(name: str, seed: int, device):
    """(label, args, expected or None) of P5 probe ``name``: the script's
    own input and expected value, then seeded ones."""
    rng = np.random.RandomState(seed)
    if name == "p1":
        x = torch.arange(24 * 32 * 128, dtype=torch.float32,
                         device=device).reshape(24, 32, 128)
        xr = _tensor(rng.randn(24, 32, 128), device)
        return [("script g=3", (x, 3), x[3:11, 4:20]),
                ("seeded g=0", (xr, 0), None), ("seeded g=8", (xr, 8), None)]
    if name == "p2":
        ones = torch.ones((32, 128), device=device)
        xr = _tensor(rng.randn(32, 128), device)
        return [("script [2, 6)", (ones, 2, 6), 4.0 * torch.ones(
                    (8, 128), device=device)),
                ("seeded [0, 25)", (xr, 0, 25), None),
                ("seeded [5, 5)", (xr, 5, 5), torch.zeros((8, 128),
                                                          device=device))]
    if name == "p3":
        ones = torch.ones((16, 128), device=device)
        return [("script ones", (ones,), 2.0 * ones),
                ("seeded N(0, 1)", (_tensor(rng.randn(16, 128), device),),
                 None),
                ("all -1", (-ones,), torch.zeros_like(ones))]
    if name == "p4":
        x = torch.ones((16, 32, 64), dtype=torch.bfloat16, device=device)
        w = torch.ones((64, 128), dtype=torch.bfloat16, device=device)
        return [("script ones", (x, w), 128.0 * torch.ones(
                    (8, 16, 128), device=device)),
                ("seeded", (_tensor(rng.randn(16, 32, 64), device,
                                    torch.bfloat16),
                            _tensor(0.1 * rng.randn(64, 128), device,
                                    torch.bfloat16)), None)]
    raise KeyError(name)


def ragged_p4_inputs(seed: int, device, shape=probes.RAGGED_P4):
    """(x, w) of ``p4`` at (K, N) = ``shape``, by default
    ``probes.RAGGED_P4``: x (16, 32, K) N(0, 1) and w (K, N) 0.1 N(0, 1),
    rounded to bf16, from ``RandomState(seed + 3)``. Not one of the probe
    path's inputs."""
    k, n = shape
    rng = np.random.RandomState(seed + 3)
    return (_tensor(rng.randn(16, 32, k), device, torch.bfloat16),
            _tensor(0.1 * rng.randn(k, n), device, torch.bfloat16))


def k1_cases(name: str, seed: int, device):
    """(label, (x, offset, mask, weight)) of K1 at the probes' shape, NCHW
    as ``ops/dcn.py`` takes it. ``k6``: (B, C, H, W, O) = (2, 16, 16, 24,
    16), the script's ones / zeros and two seeded draws; ``p5``: (1, 64, 16,
    24, 64), the script's ``RandomState(0)`` draw (NHWC, transposed)."""
    if name == "p5":
        rng = np.random.RandomState(0)
        x = rng.randn(1, 16, 24, 64)
        off = 0.3 * rng.randn(1, 16, 24, 18)
        mask = rng.rand(1, 16, 24, 9)
        w = 0.1 * rng.randn(3, 3, 64, 64)

        def nchw(a):
            return a.transpose(0, 3, 1, 2)

        return [("script", (_tensor(nchw(x), device, torch.bfloat16),
                            _tensor(nchw(off), device),
                            _tensor(nchw(mask), device),
                            _tensor(w.transpose(3, 2, 0, 1), device,
                                    torch.bfloat16)))]
    b, c, h, w, o = 2, 16, 16, 24, 16
    cases = [("script", (torch.ones((b, c, h, w), dtype=torch.bfloat16,
                                    device=device),
                         torch.zeros((b, 18, h, w), device=device),
                         torch.ones((b, 9, h, w), device=device),
                         torch.ones((o, c, 3, 3), dtype=torch.bfloat16,
                                    device=device)))]
    for case in ("narrow", "wide"):
        rng = np.random.RandomState(seed + 1 + (case == "wide"))
        s = OFFSET_SCALE[case]
        cases.append((case, (
            _tensor(rng.randn(b, c, h, w), device, torch.bfloat16),
            _tensor(rng.uniform(-s, s, (b, 18, h, w)), device),
            _tensor(rng.rand(b, 9, h, w), device),
            _tensor(0.1 * rng.randn(o, c, 3, 3), device, torch.bfloat16))))
    return cases


def bilinear_oracle(x, off, geom: Geometry):
    """P3's ``_oracle`` (``scripts/probe_dcn_bisect3.py:61``), vectorized:
    every channel of x (B, HP, WP, C) sampled bilinearly at (r + dy + pad,
    c + dx + pad), dy and dx offset channels 4 and 5 clipped to +-8; numpy
    float32 (B, H, W, C)."""
    x = np.asarray(x, np.float32)
    off = np.asarray(off, np.float32)
    g = geom
    dy = np.clip(off[:, 4], -8, 8)
    dx = np.clip(off[:, 5], -8, 8)
    py = np.arange(g.h, dtype=np.float32)[:, None] + dy + g.pad
    px = np.arange(g.w, dtype=np.float32)[None, :] + dx + g.pad
    fy0, fx0 = np.floor(py), np.floor(px)
    y0, x0 = fy0.astype(int), fx0.astype(int)
    fy, fx = (py - fy0)[..., None], (px - fx0)[..., None]
    bi = np.arange(g.batch)[:, None, None]
    return (x[bi, y0, x0] * (1 - fy) * (1 - fx)
            + x[bi, y0, x0 + 1] * (1 - fy) * fx
            + x[bi, y0 + 1, x0] * fy * (1 - fx)
            + x[bi, y0 + 1, x0 + 1] * fy * fx)


def relative(got, want) -> tuple:
    """(max |got - want|, that over max |want|; 0 when both are 0)."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, (err / scale if scale > 0 else (0.0 if err == 0 else
                                                float("inf")))


@dataclass
class Result:
    name: str
    script_name: str
    rtol: float
    cases: int = 0
    max_abs_err: float = 0.0
    max_rel_err: float = 0.0
    notes: List[str] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not self.failures

    def hold(self, label: str, got, want, rtol: float,
             what: str = "plain") -> None:
        """Holds got against want within rtol of want's largest magnitude
        (0: bitwise); records the error against the plain version."""
        if got.shape != want.shape or got.dtype != want.dtype:
            self.failures.append(f"{label}: {tuple(got.shape)} {got.dtype} "
                                 f"vs {what} {tuple(want.shape)} "
                                 f"{want.dtype}")
            return
        err, rel = relative(got, want)
        if what == "plain":
            self.cases += 1
            self.max_abs_err = max(self.max_abs_err, err)
            self.max_rel_err = max(self.max_rel_err, rel)
        if not rel <= rtol:  # a NaN fails too
            self.failures.append(f"{label}: {what} rel {rel:.3e} > {rtol}")

    def line(self) -> str:
        head = "PASS" if self.passed else "FAIL " + "; ".join(self.failures)
        return (f"[probe] {self.script_name}: {head} (max abs err "
                f"{self.max_abs_err:.3e}, rel {self.max_rel_err:.2e}, limit "
                f"{self.rtol:g}, {self.cases} cases)"
                + "".join(f"; {n}" for n in self.notes))


def tile_label(case: str, geom: Geometry) -> str:
    """The label of a tile probe's input ``case`` at ``geom``."""
    return (f"{case} at (BR, W, C, O) = ({geom.br}, {geom.w}, {geom.c}, "
            f"{geom.o})")


def check_tile_probe(name: str, device, seed: int) -> Result:
    probe = PROBES[name]
    res = Result(name, probe.script_name, probe.rtol)
    oracle_rel = 0.0
    for geom in GEOMETRIES:
        for case in CASES:
            inputs = tile_inputs(probe.script, geom, case, seed, device)
            args = [inputs[k] for k in probe.kernel.inputs]
            got = probe.kernel(*args, geom=geom)
            label = tile_label(case, geom)
            res.hold(label, got, probe.plain(*args, geom), probe.rtol)
            if name in ("kf", "kg"):
                want = torch.from_numpy(bilinear_oracle(
                    inputs["x"].float().cpu().numpy(),
                    inputs["off"].cpu().numpy(), geom))
                oracle_rel = max(oracle_rel, relative(got.cpu(), want)[1])
                res.hold(label, got.cpu(), want, ORACLE_RTOL, "P3 oracle")
    if name in ("kf", "kg"):
        res.notes.append(f"P3 oracle rel {oracle_rel:.2e} (limit "
                         f"{ORACLE_RTOL:g})")
    return res


def check_p5_probe(name: str, device, seed: int) -> Result:
    probe = PROBES[name]
    res = Result(name, probe.script_name, probe.rtol)
    for label, args, expected in p5_cases(name, seed, device):
        got = probe.kernel(*args)
        res.hold(label, got, probe.plain(*args), probe.rtol)
        if expected is not None:
            res.hold(label, got, expected, 0.0, "expected value")
    if name == "p4":
        res.notes.append("128 on the script's inputs, where the script "
                         "asserts 256: 2 x 1 summed over 64 channels is 128")
    return res


def check_k1_probe(name: str, device, seed: int) -> Result:
    script, script_name, _ = K1_PROBES[name]
    res = Result(name, script_name, K1_RTOL)
    for label, args in k1_cases(name, seed, device):
        got = probes.probe_k6(*args)
        res.hold(label, got, dcn.deform_conv2d_bf16_plain(
            *args, None, max_offset=probes.CLIP), K1_RTOL)
        if name == "p5":
            x, off, mask, w = args
            exact = dcn.deform_conv2d_plain(x.float(), off, mask, w.float())
            err = float((got.float() - exact).abs().max())
            res.notes.append(f"against the unclamped float32 DCN max abs "
                             f"{err:.3e} (the script's atol "
                             f"{P5_SCRIPT_ATOL:g}, not asserted: bf16 x and "
                             "taps over 576 terms)")
    res.notes.append("K1 through dcn_fwd_bf16, max_offset=8")
    return res


def probe_names() -> List[str]:
    """Every probe in the scripts' order: the sixteen kernels, K1's two."""
    return list(PROBES)[:5] + ["k6"] + list(PROBES)[5:] + ["p5"]


def check(name: str, device, seed: int = 0) -> Result:
    if name in K1_PROBES:
        return check_k1_probe(name, device, seed)
    if PROBES[name].script.endswith("probe_mosaic.py"):
        return check_p5_probe(name, device, seed)
    return check_tile_probe(name, device, seed)


def run(device, seed: int = 0, only: Optional[List[str]] = None,
        out=print) -> List[Result]:
    """Checks the probes (all, or those named in ``only`` by short or
    script name), prints a line each and the summary; returns the
    results."""
    names = probe_names()
    by_script = {check_name(n): n for n in names}
    chosen = names if not only else [by_script.get(n, n) for n in only]
    unknown = [n for n in chosen if n not in names]
    if unknown:
        raise SystemExit(f"probe_dcn: unknown probes {unknown}; known: "
                         f"{names}")
    results = []
    for name in chosen:
        res = check(name, device, seed)
        out(res.line())
        results.append(res)
    out("SUMMARY: " + str({r.script_name: "PASS" if r.passed else "FAIL"
                           for r in results}))
    return results


def check_name(name: str) -> str:
    """The script's name of probe ``name``."""
    if name in K1_PROBES:
        return K1_PROBES[name][1]
    return PROBES[name].script_name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", default=None,
                    help="probes by short name (k4) or script name")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    results = run(device, args.seed, args.only,
                  out=lambda s: print(s, flush=True))
    return 0 if all(r.passed for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
