"""The port's configuration dataclasses against the JAX package's.

Field names and defaults must match so a JAX config converts to the port
(``convert.config_from_dict``); settings the port's one engine cannot run
raise ``ValueError``.
"""
import dataclasses

import pytest

from option_pricing_ffn_lbfgs_tpu.utils import config as jcfg
from option_pricing_ffn_lbfgs_tpu_torch.convert import config_from_dict
from option_pricing_ffn_lbfgs_tpu_torch.utils import config as tcfg

NAMES = ["PricerConfig", "LBFGSConfig", "LMConfig", "CalibrationConfig",
         "SurfaceSpec", "GeneratorConfig"]


@pytest.mark.parametrize("name", NAMES)
def test_asdict_parity(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.is_dataclass(t) and t.__dataclass_params__.frozen


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trip(name):
    overrides = {
        "PricerConfig": dict(n_terms=64),
        "LBFGSConfig": dict(maxeval=160, gtol=1e-7),
        "LMConfig": dict(residual_impl="native", cost_target=1e-10),
        "CalibrationConfig": dict(search_impl="pallas",
                                  polish_wave_budgets=(8, 8),
                                  pricer=jcfg.PricerConfig(n_terms=32)),
        "SurfaceSpec": dict(maturities=(0.5, 1.0)),
        "GeneratorConfig": dict(n_samples=8, enforce_feller=False,
                                surface=jcfg.SurfaceSpec(spot=50.0)),
    }[name]
    j = getattr(jcfg, name)(**overrides)
    t = config_from_dict(getattr(tcfg, name), dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t == getattr(tcfg, name)(**{
        k: (config_from_dict(getattr(tcfg, type(v).__name__),
                             dataclasses.asdict(v))
            if dataclasses.is_dataclass(v) else v)
        for k, v in overrides.items()})


@pytest.mark.parametrize("field,value", [
    ("search_impl", "vmap"), ("search_impl", "batched"),
    ("search_impl", "pallas"), ("polish_impl", "vmap"),
    ("polish_impl", "pallas"), ("polish_fused_min_lanes", 1)])
def test_accepted_settings(field, value):
    cfg = dataclasses.replace(tcfg.CalibrationConfig(), **{field: value})
    tcfg.validate_calibration(cfg, tcfg.LMConfig(residual_impl="native"))
    tcfg.validate_calibration(cfg, tcfg.LMConfig(residual_impl="dd"))


@pytest.mark.parametrize("cfg,polish", [
    (dict(search_impl="xla"), {}),
    (dict(polish_impl="batched"), {}),
    (dict(polish_fused_min_lanes=-1), {}),
    ({}, dict(residual_impl="f128")),
    ({}, dict(f32_jacobian=False)),
])
def test_rejected_settings(cfg, polish):
    with pytest.raises(ValueError):
        tcfg.validate_calibration(
            dataclasses.replace(tcfg.CalibrationConfig(), **cfg),
            dataclasses.replace(tcfg.LMConfig(), **polish))


def test_lbfgs_polish_rejected():
    """The Wolfe L-BFGS polish (an LBFGSConfig, either engine flag) runs
    on the port now; a polish of any other type is still rejected."""
    for flat in (True, False):
        tcfg.validate_calibration(tcfg.CalibrationConfig(),
                                  tcfg.LBFGSConfig(flat=flat))
    with pytest.raises(ValueError):
        tcfg.validate_calibration(tcfg.CalibrationConfig(),
                                  tcfg.PricerConfig())
