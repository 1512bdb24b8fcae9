"""The port's config derivation against the JAX package's, per YAML config."""

from __future__ import annotations

import glob
import os

import pytest

from centerfusiondetect3d_tpu_torch import config as port_config

# the YAML files and the JAX package's config module need pyyaml
jax_config = pytest.importorskip("centerfusiondetect3d_tpu.config")

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.yaml")))


def _plain(node):
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def test_every_yaml_is_covered():
    assert len(CONFIGS) == 4, CONFIGS


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_derived_config_matches_jax(path):
    want = jax_config.load_config(path)
    got = port_config.load_config(path)
    assert _plain(got.heads) == _plain(want.heads)
    assert _plain(got.head_conv) == _plain(want.head_conv)
    assert tuple(got.MODEL.OUTPUT_SIZE) == tuple(want.MODEL.OUTPUT_SIZE)
    # the whole derived tree, TPU-only keys included, loads the same
    assert _plain(got) == _plain(want)


def test_default_schema_matches_jax():
    assert _plain(port_config.default_config()) == _plain(
        jax_config.default_config())


def test_overrides_and_consistency_rules_match_jax():
    opts = ["MODEL.INPUT_SIZE", "(64, 128)", "DATASET.RADAR_PC", "False",
            "MODEL.DLA.NODE", "'Conv'", "TRAIN.UNCERTAINTY_LOSS", "True",
            "MODEL.FUSION_STRATEGY", "'early'"]
    with pytest.warns(UserWarning):
        want = jax_config.load_config(opts=opts)
    with pytest.warns(UserWarning):
        got = port_config.load_config(opts=opts)
    assert _plain(got) == _plain(want)
    assert got.MODEL.FRUSTUM is False and got.MODEL.FUSION_STRATEGY is None
    with pytest.raises(KeyError):
        port_config.load_config(opts=["MODEL.NO_SUCH_KEY", "1"])


def test_smoke_overrides_mirror_centerfusion_middle_yaml():
    """chip_smoke.py builds its config without a YAML reader; its overrides
    must give the same config as configs/Centerfusion_Middle.yaml."""
    from centerfusiondetect3d_tpu_torch.runtime.synthetic import (
        MAIN_PATH_OPTS,
    )

    path = [p for p in CONFIGS if p.endswith("Centerfusion_Middle.yaml")][0]
    assert _plain(port_config.load_config(opts=MAIN_PATH_OPTS)) == _plain(
        port_config.load_config(path))


def test_smoke_main_py_overrides_are_the_campaign_config():
    """chip_smoke.py's phase 16 runs main.py at the campaign's settings as
    overrides (``CAMPAIGN_OPTS``) plus its cuts (``MAIN_PY_CUTS``): with the
    campaign's paths and the cut keys set as the YAML has them, the
    overrides give the config of ``output/campaign_r5/config.yaml``."""
    import chip_smoke

    path = os.path.join(os.path.dirname(__file__), "..", "output",
                        "campaign_r5", "config.yaml")
    campaign = port_config.load_config(path)
    cut = dict(zip(chip_smoke.MAIN_PY_CUTS[::2], chip_smoke.MAIN_PY_CUTS[1::2]))
    assert set(cut) == {"TRAIN.EPOCHS", "MODEL.DEFREEZE",
                        "TRAIN.VAL_INTERVALS", "TRAIN.SAVE_INTERVALS"}
    same = []
    for key in ("OUTPUT_DIR", "DATASET.ROOT", *cut):
        section, _, name = key.rpartition(".")
        node = campaign[section] if section else campaign
        same += [key, repr(node[name])]
    got = port_config.load_config(opts=chip_smoke.CAMPAIGN_OPTS + same)
    assert _plain(got) == _plain(campaign)
