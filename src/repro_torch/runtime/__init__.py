"""Step monitors of the training launcher (counterpart of
``repro.runtime``'s ``health`` and ``straggler``)."""
from repro_torch.runtime.health import (  # noqa: F401
    HealthMonitor, PreemptionGuard)
from repro_torch.runtime.straggler import (  # noqa: F401
    ShardStragglerMonitor, StragglerDetector)
