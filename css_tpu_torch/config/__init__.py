"""Reference-schema YAML configuration and the shipped recipes."""

import os

from css_tpu_torch.config.config import Config, dump_config, load_config

__all__ = ["Config", "load_config", "dump_config", "CONFIG_DIR"]

CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))
