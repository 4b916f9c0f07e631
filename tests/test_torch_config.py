"""nbed_tpu_torch.config against nbed_tpu.config: same schema without pydantic."""

import dataclasses
from enum import Enum
from pathlib import Path

import pytest

from nbed_tpu import config as ref
from nbed_tpu_torch import config as port

CONFIG_JSON = Path(__file__).parent / "test_config.json"


def _default(value):
    return value.value if isinstance(value, Enum) else value


def test_field_names_and_defaults_match():
    ref_fields = ref.NbedConfig.model_fields
    port_fields = {f.name: f for f in dataclasses.fields(port.NbedConfig)}
    assert list(port_fields) == list(ref_fields)
    for name, info in ref_fields.items():
        if info.is_required():
            assert port_fields[name].default is dataclasses.MISSING, name
        else:
            assert _default(port_fields[name].default) == _default(info.default), name


@pytest.mark.parametrize("enum_name", ["ProjectorTypes", "OccupiedLocalizerTypes",
                                       "VirtualLocalizerTypes"])
def test_enum_values_match(enum_name):
    ref_enum, port_enum = getattr(ref, enum_name), getattr(port, enum_name)
    assert {(e.name, e.value) for e in ref_enum} == {(e.name, e.value) for e in port_enum}


def test_config_json_parses_like_reference():
    ours = port.parse_config(str(CONFIG_JSON))
    theirs = ref.parse_config(str(CONFIG_JSON))
    assert ours.as_dict() == theirs.model_dump(mode="json")


def test_geometry_path_and_keyword_overrides(water_filepath):
    cfg = port.parse_config(geometry=str(water_filepath), n_active_atoms=1,
                            basis="STO-3G", xc_functional="b3lyp")
    assert cfg.geometry == water_filepath.read_text()
    cfg2 = port.parse_config(cfg, projector="huzinaga")
    assert cfg2.projector is port.ProjectorTypes.HUZ
    assert cfg.projector is port.ProjectorTypes.MU


@pytest.mark.parametrize("bad", [
    {"n_active_atoms": 0},
    {"occupied_threshold": 1.5},
    {"projector": "nope"},
    {"symmetry": True},
    {"convergence": -1.0},
    {"geometry": "not xyz"},
    {"qubit_mapping": "xx"},
    {"n_mo_overwrite": (1, 2, 3)},
])
def test_invalid_values_raise(bad, water_xyz):
    kwargs = dict(geometry=water_xyz, n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp")
    kwargs.update(bad)
    with pytest.raises(ValueError):
        port.NbedConfig(**kwargs)
    with pytest.raises(Exception):
        ref.NbedConfig(**kwargs)


@pytest.mark.parametrize("field,value", [
    ("run_dft_in_dft", True), ("run_vqe_emb", True), ("run_cis_emb", 2),
    ("run_rpa_emb", 1), ("taper_qubits", True), ("warmup_f32", True),
    ("density_fitting", True), ("localization", "pm"),
    ("virtual_localization", "pao"), ("mm_charges", [0.1]),
])
def test_unported_features_raise_naming_roadmap(field, value, water_xyz):
    cfg = port.NbedConfig(geometry=water_xyz, n_active_atoms=1, basis="STO-3G",
                          xc_functional="b3lyp", **{field: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cfg.require_ported()
