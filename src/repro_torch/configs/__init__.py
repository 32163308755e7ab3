from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      register)

__all__ = ["ModelConfig", "get_config", "list_archs", "register"]
