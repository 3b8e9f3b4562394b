"""Service shell — port of ``spark_fsm_tpu/service``: a stdlib HTTP front
end over thread-based actor workers, an in-process Redis-compatible
result/status store, pluggable sequence sources, and the algorithm plugin
registry selected by the request's ``algorithm`` parameter, over the
port's engines on the service's device."""

from spark_fsm_tpu_torch.service.model import (  # noqa: F401
    ServiceRequest,
    ServiceResponse,
    Status,
)
from spark_fsm_tpu_torch.service.plugins import ALGORITHMS, AlgorithmPlugin  # noqa: F401
from spark_fsm_tpu_torch.service.store import ResultStore  # noqa: F401
