"""Configurator: YAML -> validated config -> assembled simulation.

Port of mundy_tpu/driver/configurator.py (the reference's
Configurator/Driver, `Configurator.hpp:98,181-208`, `Driver.hpp:96`): a
registry maps app names to (config schema, simulation class); YAML
populates the schema with unknown-key rejection and numeric coercion
(core/config.py), and every sim is built on the device the caller names.
"""

from __future__ import annotations

from typing import Optional

from mundy_tpu_torch.core.config import ConfigError, config_from_dict, load_yaml

# app name -> (config class, sim factory); filled on first use, so that
# importing the configurator does not import every app
_REGISTRY: dict = {}


def make_rods_sim(config, device="cuda"):
    """Engine selection for config #3, as the reference makes it: the (N, K)
    RodsSim for engine="nmat", ellipsoids and friction (their narrow phases
    and the friction history run per neighbor slot), the row narrow phase
    (rods_rows.RowRodsSim) when engine="rows" or the box admits >= 5 row
    cells per axis, else RodsSim."""
    from mundy_tpu_torch.driver.apps.rods import RodsSim
    from mundy_tpu_torch.driver.apps.rods_rows import RowRodsSim

    if config.engine == "nmat" or config.shape == "ellipsoid" or config.friction:
        return RodsSim(config, device=device)
    cutoff = config.length + 2 * config.radius + config.skin
    feasible = int(config.box_size // cutoff) >= 5
    if config.engine == "rows" or feasible:
        return RowRodsSim(config, device=device)
    return RodsSim(config, device=device)


def _registry() -> dict:
    if _REGISTRY:
        return _REGISTRY
    from mundy_tpu_torch.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu_torch.driver.apps.filaments import FilamentsConfig, FilamentsSim
    from mundy_tpu_torch.driver.apps.granular import GranularConfig, GranularSim
    from mundy_tpu_torch.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu_torch.driver.apps.rods import RodsConfig
    from mundy_tpu_torch.driver.apps.spheres import SpheresConfig, SpheresSim

    _REGISTRY.update({
        "spheres": (SpheresConfig, SpheresSim),
        "lcp_spheres": (LCPSpheresConfig, LCPSpheresSim),
        "rods": (RodsConfig, make_rods_sim),
        "filaments": (FilamentsConfig, FilamentsSim),
        "chromatin": (ChromatinConfig, ChromatinSim),
        "granular": (GranularConfig, GranularSim),
    })
    return _REGISTRY


def available_apps() -> list:
    return sorted(_registry().keys())


def config_from_spec(spec: dict):
    """{"app": name, "params": {...}} -> (app name, config). Raises
    ConfigError, with the valid choices, on an unknown app or key."""
    reg = _registry()
    if "app" not in spec:
        raise ConfigError(f"config must name an 'app'; available: {available_apps()}")
    app = spec["app"]
    if app not in reg:
        raise ConfigError(f"unknown app '{app}'; available: {available_apps()}")
    params = spec.get("params", {}) or {}
    return app, config_from_dict(reg[app][0], params, path=f"{app}.params")


def build_simulation(spec: dict, device="cuda"):
    """{"app": name, "params": {...}} -> (config, sim on `device`)."""
    app, config = config_from_spec(spec)
    return config, _registry()[app][1](config, device=device)


def load_spec(path: str, overrides: Optional[dict] = None) -> dict:
    """A YAML app spec with key=value overrides applied to its params."""
    spec = load_yaml(path)
    if overrides:
        spec = {**spec, "params": {**(spec.get("params", {}) or {}), **overrides}}
    return spec


def build_simulation_from_yaml(path: str, overrides: Optional[dict] = None, device="cuda"):
    """Load a YAML app spec, apply key=value overrides to its params, build
    the sim on `device`."""
    return build_simulation(load_spec(path, overrides), device=device)
