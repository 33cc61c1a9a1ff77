"""Configuration dataclasses of the port: the JAX package's framework-free
``haconvdr_tpu.config`` (plain dataclasses, no jax import), shared so both
packages read one configuration, not copied.  Import them from here."""

from haconvdr_tpu.config import DataConfig, ModelConfig, SearchConfig, config_from_argv

__all__ = ["DataConfig", "ModelConfig", "SearchConfig", "config_from_argv"]
