from repro_torch.configs.base import ArchConfig, reduced
from repro_torch.configs.registry import CONFIGS, get_config, get_reduced_config
