"""Configurations of the port (the DIFET paper's deployment)."""
from repro_torch.configs.difet_paper import (  # noqa: F401
    DifetConfig, PAPER_ALGORITHMS, PAPER_CONFIG,
)
