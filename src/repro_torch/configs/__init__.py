from repro_torch.configs.base import ModelConfig, get_config, register

__all__ = ["ModelConfig", "get_config", "register"]
