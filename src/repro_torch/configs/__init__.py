from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MLP_GEGLU,
                                      MLP_GELU, MLP_MOE, MLP_NONE, MLP_SWIGLU,
                                      RGLRU, SSD, LayerSpec, ModelConfig,
                                      ParallelConfig, ShapeConfig)
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
