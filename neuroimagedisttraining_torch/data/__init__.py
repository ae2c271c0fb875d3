from .synthetic import device_synthetic_federated, make_synthetic_federated
from .types import FederatedData, pad_stack

__all__ = ["FederatedData", "pad_stack", "make_synthetic_federated",
           "device_synthetic_federated"]
