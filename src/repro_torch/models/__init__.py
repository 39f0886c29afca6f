"""The LM substrate's model library (port of ``repro.models``): layers,
attention (GQA, MLA, cross), MoE, SSM blocks (Mamba2, mLSTM, sLSTM), the
per-family blocks and the model facades."""
from repro_torch.models.model import build_model  # noqa: F401
