"""The LR-schedule CLI of the port against the JAX package's.

``python -m centerfusiondetect3d_tpu_torch.training.schedule`` prints the
per-epoch trace as ``centerfusiondetect3d_tpu.training.schedule.main``
does: both ``main``s run in this process on the same arguments, and their
printed lines must be equal, character for character (the LRs are printed
to four significant digits, and the two ``learning_rate`` are the same
arithmetic on the same float64 values). Cases: the shipped
``Centerfusion_Middle.yaml`` and ``CenterNet.yaml``, the CLR scheduler,
and every phase of the training campaign at both scales
(``tools/train_campaign.py:schedule_argv``), each at several
``--start-epoch``. ``--plot`` writes a PNG through
``utils/observability.py:plot_lr_schedule``.
"""

from __future__ import annotations

import os

import pytest

from centerfusiondetect3d_tpu_torch.tools import train_campaign
from centerfusiondetect3d_tpu_torch.training import schedule

jax_schedule = pytest.importorskip("centerfusiondetect3d_tpu.training.schedule")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIDDLE = os.path.join(ROOT, "configs", "Centerfusion_Middle.yaml")
CENTERNET = os.path.join(ROOT, "configs", "CenterNet.yaml")


def _printed(main, argv, capsys):
    trace = main(argv)
    return trace, capsys.readouterr().out.splitlines()


def _same_output(argv, capsys):
    got, got_lines = _printed(schedule.main, argv, capsys)
    want, want_lines = _printed(jax_schedule.main, argv, capsys)
    assert got_lines == want_lines
    assert got == want
    assert len(got_lines) == len(got) > 0
    return got_lines


@pytest.mark.parametrize("cfg,start", [
    (MIDDLE, 0), (MIDDLE, 4), (MIDDLE, 170), (MIDDLE, 186),
    (CENTERNET, 0), (CENTERNET, 4), (CENTERNET, 95), (CENTERNET, 121)],
    ids=lambda v: os.path.basename(str(v)))
def test_shipped_configs_print_as_jax(cfg, start, capsys):
    pytest.importorskip("yaml")
    _same_output(["--cfg", cfg, "--start-epoch", str(start)], capsys)


@pytest.mark.parametrize("start", [0, 3, 12])
def test_clr_and_overrides_print_as_jax(start, capsys):
    _same_output(["--start-epoch", str(start), "TRAIN.LR_SCHEDULER", "'CLR'",
                  "TRAIN.WARM_EPOCHS", "0", "TRAIN.EPOCHS", "40",
                  "MODEL.DEFREEZE", "8", "TRAIN.LR_STEP", "(20, 30)"], capsys)


def _phase_cfgs(scale):
    args = train_campaign.parse_args(["--scale", scale])
    sc = train_campaign.SCALES[scale]
    return sc, train_campaign.phase_cfgs(args, sc, "/data/nuscenes",
                                         "/campaign")


@pytest.mark.parametrize("scale", sorted(train_campaign.SCALES))
def test_campaign_phases_print_as_jax(scale, capsys):
    sc, cfgs = _phase_cfgs(scale)
    phases = [p for p in cfgs if p != "final"]
    assert phases == (["phase1", "phase2", "phase3", "phase4"]
                      if scale == "full" else ["phase1", "phase2"])
    for name in phases:
        start = train_campaign.phase_start_epoch(sc, name)
        for s in (start, start + 1):
            lines = _same_output(train_campaign.schedule_argv(cfgs[name], s),
                                 capsys)
            assert lines[0].startswith(f"epoch {s:4d}  lr ")


def test_campaign_phase_lrs_are_the_scripts(capsys):
    """The full campaign's LR at a few epochs, by hand from the script:
    2.5e-4 warmed over 2 epochs and re-warmed after DEFREEZE 2, stepped at
    55; phase 3 back at 2.5e-4, stepped at 130; phase 4 at 2.5e-5."""
    sc, cfgs = _phase_cfgs("full")
    trace = {name: dict(zip(range(train_campaign.phase_start_epoch(sc, name),
                                  int(cfg.TRAIN.EPOCHS)),
                            schedule.schedule_trace(
                                cfg, start_epoch=train_campaign.
                                phase_start_epoch(sc, name))))
             for name, cfg in cfgs.items() if name != "final"}
    assert trace["phase1"][0] == pytest.approx(2.5e-4 / 4)
    assert trace["phase1"][29] == pytest.approx(2.5e-4)
    assert trace["phase2"][56] == pytest.approx(2.5e-5)
    assert trace["phase3"][100] == pytest.approx(2.5e-4)
    assert trace["phase3"][140] == pytest.approx(2.5e-5)
    assert sorted(set(trace["phase4"].values())) == pytest.approx(
        [2.5e-5 / 4, 2.5e-5 / 2, 2.5e-5])


def test_plot_writes_a_png(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "lr.png"
    trace = schedule.main(["--plot", str(out), "TRAIN.EPOCHS", "12"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"wrote {out}"
    assert len(lines) == len(trace) + 1 == 13
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
