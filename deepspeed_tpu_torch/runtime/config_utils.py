"""Typed-config plumbing, copied from ``deepspeed_tpu/runtime/config_utils.py``
(the port keeps its own copy and never imports the JAX package): each config
block is a dataclass built from a (possibly partial) dict; unknown keys
raise."""

import dataclasses


class ConfigError(ValueError):
    pass


def from_dict(cls, data: dict, path: str = ""):
    """Build dataclass ``cls`` from ``data``, recursing into nested dataclass
    fields; unknown keys are an error (catches config typos early, like the
    reference's pydantic models)."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"config block {path or cls.__name__} must be a dict, got {type(data).__name__}")
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    # accept both canonical names and documented aliases
    aliases = getattr(cls, "_aliases", {})
    kwargs = {}
    for key, value in data.items():
        name = aliases.get(key, key)
        if name not in field_map:
            raise ConfigError(f"Unknown config key '{path}{key}' for {cls.__name__}")
        f = field_map[name]
        if dataclasses.is_dataclass(f.type) and isinstance(value, dict):
            value = from_dict(f.type, value, path=f"{path}{key}.")
        kwargs[name] = value
    obj = cls(**kwargs)
    # recurse defaults for nested dataclass fields passed as dicts via defaults
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if isinstance(v, dict) and dataclasses.is_dataclass(_resolve_type(f)):
            setattr(obj, f.name, from_dict(_resolve_type(f), v, path=f"{path}{f.name}."))
    return obj


def _resolve_type(f):
    return f.type if dataclasses.is_dataclass(f.type) else None

