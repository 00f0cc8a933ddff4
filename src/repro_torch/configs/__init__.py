"""Architecture configs: the 10 assigned pool architectures.

``get_config(name)`` returns the full-size ArchCfg; ``get_config(name,
reduced=True)`` returns the CPU-smoke-test reduction (≤2 layers,
d_model ≤ 512, ≤4 experts) of the same family.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchCfg, MoESpec, ARCH_REGISTRY, get_config, list_archs,
    INPUT_SHAPES, param_count, model_flops,
)
