from .base import FedAlgorithm, sample_client_indexes
from .dispfl import DisPFL, DisPFLState
from .ditto import Ditto, DittoState
from .dpsgd import DPSGD, DPSGDState
from .fedavg import FedAvg, FedAvgState
from .fedfomo import FedFomo, FedFomoState
from .local_only import LocalOnly, LocalOnlyState
from .salientgrads import SalientGrads, SalientGradsState
from .subavg import SubAvg, SubAvgState
from .turboaggregate import TurboAggregate, TurboAggregateState

#: the algorithms by their reference names (the CLI's ``--algo``)
ALGORITHMS = {cls.name: cls for cls in (
    FedAvg, SalientGrads, DisPFL, SubAvg, Ditto, LocalOnly, DPSGD, FedFomo,
    TurboAggregate)}

__all__ = ["ALGORITHMS", "DPSGD", "DPSGDState", "DisPFL", "DisPFLState",
           "Ditto", "DittoState", "FedAlgorithm", "FedAvg", "FedAvgState",
           "FedFomo", "FedFomoState", "LocalOnly", "LocalOnlyState",
           "SalientGrads", "SalientGradsState", "SubAvg", "SubAvgState",
           "TurboAggregate", "TurboAggregateState", "sample_client_indexes"]
