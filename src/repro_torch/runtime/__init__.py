from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    Heartbeat, RestartReport, StepMonitor, elastic_remesh_plan,
    run_with_restarts,
)
