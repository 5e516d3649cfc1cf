from repro_torch.configs.moses import DEFAULT as MOSES_DEFAULT
from repro_torch.configs.moses import CostModelConfig, MosesConfig

__all__ = ["MOSES_DEFAULT", "CostModelConfig", "MosesConfig"]
