"""Port: owlvit_tpu_torch/utils/config.py stays a field-for-field copy of the
JAX package's owlvit_tpu/utils/config.py."""

import dataclasses
import os

import pytest

from owlvit_tpu.utils import config as jconfig
from owlvit_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _default(f):
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return f.default


@pytest.mark.parametrize("cls", ["DataConfig", "TrainingConfig", "ModelConfig", "Config"])
def test_fields_and_defaults_match(cls):
    ours, theirs = dataclasses.fields(getattr(tconfig, cls)), dataclasses.fields(getattr(jconfig, cls))
    assert [(f.name, str(f.type), _default(f)) for f in ours] == \
           [(f.name, str(f.type), _default(f)) for f in theirs]


def test_load_config_matches(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("training:\n  learning_rate: 1e-4\n  log_file: false\n"
                    "  stage_pixels: true\nmodel:\n  name: b16\n")
    for cfg_path in (os.path.join(REPO, "config.yaml"), str(path)):
        assert (dataclasses.asdict(tconfig.load_config(cfg_path))
                == dataclasses.asdict(jconfig.load_config(cfg_path)))
    with pytest.raises(ValueError, match="unknown keys"):
        path.write_text("model:\n  nmae: b16\n")
        tconfig.load_config(str(path))
