from .base import FedAlgorithm, sample_client_indexes
from .salientgrads import SalientGrads, SalientGradsState

__all__ = ["FedAlgorithm", "SalientGrads", "SalientGradsState",
           "sample_client_indexes"]
