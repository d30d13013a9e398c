from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, DECODE,
                                      MLP_GEGLU, MLP_GELU, MLP_MOE, MLP_NONE,
                                      MLP_SWIGLU, PREFILL, RGLRU, SHAPES, SSD,
                                      TRAIN, LayerSpec, ModelConfig,
                                      MoEConfig, ParallelConfig, RGLRUConfig,
                                      RunConfig, ShapeConfig, SSMConfig)
from repro_torch.configs.registry import (ARCH_IDS, Cell, cell_skip_reason,
                                          cells, get_config,
                                          get_smoke_config)
