"""Config dataclasses (`configs`, `method_configs`, `default_configs`)."""
