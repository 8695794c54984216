from efficientat_tpu_torch.models.dymn import DyMN, DyMNConfig, dyconv_temperature
from efficientat_tpu_torch.models.ensemble import Ensemble
from efficientat_tpu_torch.models.htsat import HTSAT, HTSATConfig
from efficientat_tpu_torch.models.mn import MN, MNConfig, init_weights, mn_block_table
from efficientat_tpu_torch.models.passt import PaSST, PaSSTConfig
from efficientat_tpu_torch.models.registry import (
    REGISTRY,
    ModelSpec,
    build_model,
    get_model_config,
)

__all__ = [
    "DyMN",
    "DyMNConfig",
    "Ensemble",
    "HTSAT",
    "HTSATConfig",
    "MN",
    "MNConfig",
    "ModelSpec",
    "PaSST",
    "PaSSTConfig",
    "REGISTRY",
    "build_model",
    "dyconv_temperature",
    "get_model_config",
    "init_weights",
    "mn_block_table",
]
