from .base import FedAlgorithm, sample_client_indexes
from .fedavg import FedAvg, FedAvgState
from .salientgrads import SalientGrads, SalientGradsState

__all__ = ["FedAlgorithm", "FedAvg", "FedAvgState", "SalientGrads",
           "SalientGradsState", "sample_client_indexes"]
