"""Step monitors and elastic recovery of the training launcher
(counterpart of ``repro.runtime``): the health and straggler monitors,
the fault injector of the drills (``faults``) and the elastic plans
(``elastic``; ``build_groups`` is the counterpart of JAX's
``build_mesh``)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    ElasticPlan, build_groups, make_plan)
from repro_torch.runtime.health import (  # noqa: F401
    HealthMonitor, PreemptionGuard)
from repro_torch.runtime.straggler import (  # noqa: F401
    ShardStragglerMonitor, StragglerDetector)
