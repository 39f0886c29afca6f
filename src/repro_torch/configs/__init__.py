"""Configurations of the port: the DIFET paper's deployment and the LM
substrate's architectures.  Importing this package registers every
architecture in the registry of ``configs/base.py``."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, MLAConfig, SSMConfig, XLSTMConfig,
    ShapeConfig, SHAPES, applicable_shapes, get_config, all_arch_ids,
)
from repro_torch.configs.difet_paper import (  # noqa: F401
    DifetConfig, PAPER_ALGORITHMS, PAPER_CONFIG,
)
# architecture modules register themselves on import
from repro_torch.configs import (  # noqa: F401
    internlm2_1_8b,
    qwen1_5_110b,
    glm4_9b,
    smollm_135m,
    whisper_large_v3,
    deepseek_v3_671b,
    dbrx_132b,
    internvl2_2b,
    xlstm_350m,
    zamba2_2_7b,
)

ARCH_IDS = all_arch_ids()
