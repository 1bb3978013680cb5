from eesen_tpu_torch.models.bilstm import (
    BiLstmConfig,
    init_bilstm_layer,
    bilstm_layer,
)
from eesen_tpu_torch.models.model import (
    AcousticModelConfig,
    init_model,
    apply_model,
    model_num_params,
)

__all__ = [
    "BiLstmConfig",
    "init_bilstm_layer",
    "bilstm_layer",
    "AcousticModelConfig",
    "init_model",
    "apply_model",
    "model_num_params",
]
