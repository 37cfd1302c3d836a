"""Model definitions of the port (base and lite presets)."""
from atmvfi_tpu_torch.models.config import BASE, LITE, ATMVFIConfig, get_config
from atmvfi_tpu_torch.models.network import Network

__all__ = ["ATMVFIConfig", "BASE", "LITE", "Network", "get_config"]
